"""Dataset execution context.

Parity: reference ``python/ray/data/context.py`` — a per-driver
singleton of execution knobs; the subset that changes behavior here is
the shuffle strategy selection (``use_push_based_shuffle``, reference
``DatasetContext.use_push_based_shuffle``), merge factor, and the
streaming-execution knobs consumed by ``ray_tpu_torch/data/streaming.py``
(see docs/data.md for the full table).
"""

from __future__ import annotations

import threading
from typing import Optional


class DataContext:
    _instance: Optional["DataContext"] = None
    _lock = threading.Lock()

    def __init__(self):
        #: two-stage pipelined shuffle (reference push_based_shuffle.py)
        #: instead of the all-to-all pull shuffle
        self.use_push_based_shuffle = False
        #: mapper outputs merged in groups of this size per round
        self.push_based_shuffle_merge_factor = 2
        #: rows per batch when iterating without an explicit batch_size
        self.target_batch_size = 256

        # ---- streaming execution (data/streaming.py) -----------------
        #: bounded in-flight block budget: blocks executing + produced-
        #: but-unconsumed may never exceed this, so ingest cannot
        #: front-load the arena no matter how large the dataset is
        self.streaming_block_budget = 8
        #: arena-used fraction above which the executor stalls new block
        #: admissions (progress guaranteed: one block stays in flight);
        #: sits below the raylet's object_spill_threshold so streaming
        #: backs off *before* the create path starts spilling
        self.streaming_arena_watermark = 0.75
        #: how often the executor re-probes local arena pressure (the
        #: probe is one raylet RPC; admissions between probes reuse the
        #: cached reading)
        self.streaming_arena_probe_interval_s = 0.5
        #: batches assembled ahead of the consumer by the shard
        #: iterator's prefetch thread (the next batch decodes while the
        #: current train step runs); 0 disables the thread
        self.streaming_prefetch_batches = 2
        #: yield blocks in input order (True) or as they complete
        #: (False — lower latency under stragglers, nondeterministic
        #: order)
        self.streaming_preserve_order = True
        #: route streaming map tasks toward the node holding their
        #: input block (owner-side lease locality; also gated by the
        #: cluster-level ``task_locality_enabled`` knob)
        self.streaming_locality_enabled = True
        #: trainer ingest: TorchTrainer shards ray_tpu_torch Datasets with
        #: ``streaming_split`` (per-rank prefetching shard iterators)
        #: instead of the materialize-then-split path
        self.streaming_train_ingest = False

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._instance is None:
                cls._instance = DataContext()
            return cls._instance
