"""Durable workflows (reference ``python/ray/workflow/``)."""

from ray_tpu_torch.workflow.workflow import (  # noqa: F401
    FAILED,
    RESUMABLE,
    RUNNING,
    SUCCEEDED,
    Continuation,
    WorkflowManagementActor,
    WorkflowStorage,
    continuation,
    delete,
    get_output,
    get_status,
    init,
    list_all,
    options,
    resume,
    run,
    send_event,
    wait_for_event,
)
