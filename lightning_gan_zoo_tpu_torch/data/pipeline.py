# Copied from lightning_gan_zoo_tpu/data/pipeline.py (jax-free; kept in step with it by hand).
"""Input pipeline: shuffled epochs of stacked superstep batches.

Replaces the reference's DataLoader-per-epoch pattern
(core/lightning_module.py:89-102, reload_dataloaders_every_epoch at
run_network.py:69). The TPU superstep consumes (disc_freq+gen_freq)·accum
micro-batches per dispatch, so the pipeline yields pytrees with a leading
[n_micro, batch, ...] axis, prefetched on a background thread while the
device computes.

Per-host sharding for multi-process meshes: each process reads a disjoint
index stripe (process_index::process_count), the pjit data axis consumes the
per-host batch — the DistributedSampler equivalent (SURVEY §5.8).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class EpochLoader:
    def __init__(self, dataset, batch_size: int, n_micro: int = 1,
                 shuffle: bool = True, seed: int = 42,
                 drop_last: bool = True, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.n_micro = int(n_micro)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        # batch_size is the GLOBAL batch (training semantics must not
        # change with host count — the BatchNorm/penalty-statistics
        # contract, COMPONENTS.md); each process loads and yields only its
        # stripe, and parallel/mesh.put_batch assembles the global array
        # from the per-process shards
        if self.batch_size % self.process_count:
            raise ValueError(
                f"global batch_size={self.batch_size} must divide over "
                f"{self.process_count} processes")
        self.local_batch = self.batch_size // self.process_count

    def steps_per_epoch(self) -> int:
        per_host = len(self.dataset) // self.process_count
        span = self.local_batch * self.n_micro
        return per_host // span

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield stacked superstep batches for one epoch (background thread)."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch_idx)
            rng.shuffle(order)
        order = order[self.process_index::self.process_count]
        span = self.local_batch * self.n_micro
        # the step count must be GLOBALLY consistent: stripes differ by one
        # element when process_count doesn't divide len(dataset), and a
        # process dispatching one extra collective superstep would deadlock
        # its peers — derive the count from the common floor, not this
        # stripe's length
        per = n // self.process_count
        n_steps = per // span if self.drop_last else -(-per // span)
        if n_steps == 0:
            raise ValueError(
                f"Dataset of {n} images yields zero supersteps at "
                f"batch={self.batch_size}×{self.n_micro} micro-batches")

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checking_stop(item) -> bool:
            """Bounded put that re-checks the stop event, so an early
            consumer exit (fast_dev_run break, mid-epoch exception) can't
            leave the worker blocked forever on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for s in range(n_steps):
                    if stop.is_set():
                        return
                    idx = order[s * span:(s + 1) * span]
                    if len(idx) < span:  # pad the ragged tail batch
                        idx = np.concatenate([idx, order[:span - len(idx)]])
                    flat = self.dataset.load(idx)
                    stacked = {
                        k: (v.reshape((self.n_micro, self.local_batch)
                                      + v.shape[1:])
                            if not isinstance(v, dict) else
                            {kk: vv.reshape((self.n_micro, self.local_batch)
                                            + vv.shape[1:])
                             for kk, vv in v.items()})
                        for k, v in flat.items()}
                    if not put_checking_stop(stacked):
                        return
                put_checking_stop(None)
            except BaseException as e:  # surface loader errors to consumer
                put_checking_stop(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
