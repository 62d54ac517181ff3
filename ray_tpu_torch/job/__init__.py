"""Job submission (reference ``dashboard/modules/job/``)."""

from ray_tpu_torch.job.job_manager import (  # noqa: F401
    FAILED,
    PENDING,
    RUNNING,
    STOPPED,
    SUCCEEDED,
    JobManager,
    JobSupervisor,
)
from ray_tpu_torch.job.sdk import JobSubmissionClient  # noqa: F401
