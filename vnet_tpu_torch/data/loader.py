"""Prefetching batch loader.

Replaces the reference's serialized ``tf.data.map(py_func,
num_parallel_calls=1)`` + feed_dict round trip
(reference `pipeline/NiftiDataset3D.py:47-50`,
reference `model.py:735-748`) with a prefetcher: workers run the
sample parsers ahead of the training loop and batches are assembled
contiguous for the trainer's host-to-device copy, so the card never
waits on SimpleITK-style host work. Epoch semantics match the
reference: shuffle each epoch, fixed batch size, ``drop_remainder``
(`model.py:289-293`).

Two parallel backends:

* ``backend="thread"`` — worker threads; cheap, fine when the parsers
  spend their time in GIL-releasing numpy/scipy kernels.
* ``backend="process"`` — forked worker processes for production-scale
  pipelines where Python-level transform code is the bottleneck (the GIL
  serializes threads there). Each sample's stochastic transforms are
  seeded deterministically from ``(loader seed, epoch, position)``, so
  results are reproducible regardless of which worker picks up which
  sample — unlike the reference's global ``np.random`` state.
  Caveat: workers fork from a parent that may hold a CUDA context;
  children only run numpy/scipy parser code and never touch CUDA, the
  same posture as PyTorch's fork-based DataLoader. Use
  ``backend="thread"`` (the default) if your transforms call into torch.

The port's copy of ``vnet_tpu/data/loader.py``, equal in behaviour.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from .rand import get_rng


class BatchLoader:
    """Iterate epochs of batches over a dataset with worker prefetch.

    Args:
      dataset: object with ``__len__`` and ``get_sample(i) -> (img, lbl)``.
      batch_size: samples per batch.
      shuffle: reshuffle sample order each epoch.
      drop_remainder: drop the trailing partial batch (reference behavior).
      num_workers: prefetch threads (0 = synchronous).
      prefetch: max ready samples buffered ahead.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_remainder: bool = True, num_workers: int = 2,
                 prefetch: int = 8, seed: Optional[int] = None,
                 skip_errors: bool = False, backend: str = "thread"):
        if backend not in ("thread", "process"):
            raise ValueError(f"backend must be 'thread' or 'process', "
                             f"got {backend!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.num_workers = num_workers
        self.backend = backend
        self.prefetch = max(prefetch, batch_size)
        self._epoch_rng = np.random.default_rng(seed)
        # skip_errors=True logs and drops failing samples instead of
        # aborting the epoch — the reference hard-exits the process on any
        # preprocessing error (NiftiDataset3D.py:143-147, SURVEY.md §5.3)
        self.skip_errors = skip_errors
        self.error_count = 0

    def _order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._epoch_rng.shuffle(order)
        return order

    def _iter_samples_sync(self, order) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in order:
            try:
                yield self.dataset.get_sample(int(i))
            except Exception as e:
                if not self.skip_errors:
                    raise
                self.error_count += 1
                print(f"BatchLoader: skipping failed sample {i}: {e}")

    def _iter_samples_threaded(self, order) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        task_q: "queue.Queue" = queue.Queue()
        done_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        for pos, i in enumerate(order):
            task_q.put((pos, int(i)))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    pos, i = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    done_q.put((pos, self.dataset.get_sample(i), None))
                except Exception as e:  # surface errors on the main thread
                    done_q.put((pos, None, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        # re-order results into submission order so epochs are reproducible
        pending = {}
        next_pos = 0
        try:
            for _ in range(len(order)):
                while next_pos not in pending:
                    pos, sample, err = done_q.get()
                    pending[pos] = (sample, err)
                sample, err = pending.pop(next_pos)
                next_pos += 1
                if err is not None:
                    if not self.skip_errors:
                        raise err
                    self.error_count += 1
                    print(f"BatchLoader: skipping failed sample: {err}")
                    continue
                yield sample
        finally:
            stop.set()
            while not task_q.empty():
                try:
                    task_q.get_nowait()
                except queue.Empty:
                    break

    def _iter_samples_process(self, order) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Forked worker processes. Per-sample RNG seeding makes the epoch
        deterministic regardless of worker scheduling."""
        ctx = mp.get_context("fork")
        seeds = self._epoch_rng.integers(0, 2 ** 63, size=len(order))
        task_q = ctx.Queue()
        done_q = ctx.Queue(maxsize=self.prefetch)
        for pos, i in enumerate(order):
            task_q.put((pos, int(i), int(seeds[pos])))
        n_workers = max(1, self.num_workers)
        for _ in range(n_workers):
            task_q.put(None)  # one stop sentinel per worker

        dataset = self.dataset

        def worker():
            from . import rand
            while True:
                task = task_q.get()
                if task is None:
                    return
                pos, i, sample_seed = task
                rand.seed(sample_seed)
                try:
                    sample = dataset.get_sample(i)
                    done_q.put((pos, sample, None))
                except Exception as e:  # pickle the message, not the object
                    done_q.put((pos, None, f"{type(e).__name__}: {e}"))

        procs = [ctx.Process(target=worker, daemon=True)
                 for _ in range(n_workers)]
        for p in procs:
            p.start()

        pending = {}
        next_pos = 0
        clean = False
        try:
            for _ in range(len(order)):
                while next_pos not in pending:
                    # bounded wait + liveness check: a worker that dies
                    # without posting (OOM-kill, segfaulting parser) must
                    # surface as an error, not a silent eternal hang
                    while True:
                        try:
                            pos, sample, err = done_q.get(timeout=10.0)
                            break
                        except queue.Empty:
                            dead = [p for p in procs if not p.is_alive()
                                    and p.exitcode not in (0, None)]
                            if dead:
                                raise RuntimeError(
                                    "BatchLoader worker died (exit codes "
                                    f"{[p.exitcode for p in dead]}) without "
                                    "posting a result — aborting epoch")
                            if not any(p.is_alive() for p in procs):
                                # every worker exited "cleanly" (e.g. a
                                # parser called sys.exit(0)) yet results
                                # are still missing; drain once more in
                                # case data is in flight, then abort
                                try:
                                    pos, sample, err = done_q.get(
                                        timeout=1.0)
                                    break
                                except queue.Empty:
                                    raise RuntimeError(
                                        "BatchLoader workers all exited "
                                        "without posting every result — "
                                        "aborting epoch") from None
                    pending[pos] = (sample, err)
                sample, err = pending.pop(next_pos)
                next_pos += 1
                if err is not None:
                    if not self.skip_errors:
                        raise RuntimeError(
                            f"sample {next_pos - 1} failed in worker: {err}")
                    self.error_count += 1
                    print(f"BatchLoader: skipping failed sample: {err}")
                    continue
                yield sample
            clean = True
        finally:
            if clean:
                # normal completion: workers exit via their sentinel
                for p in procs:
                    p.join(timeout=10)
            # terminate stragglers / abnormal exit paths
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)

    def epoch(self) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield batches: each dataset sample tuple element is stacked along
        a new leading batch dim — ``(images, labels[, distance_maps, ...])``.
        """
        order = self._order()
        if self.backend == "process" and not getattr(self, "_warmed", False):
            # datasets with a deterministic-prefix cache warm it in the
            # parent so per-epoch forked workers inherit it (COW) instead
            # of rebuilding it from scratch every epoch
            warm = getattr(self.dataset, "warm_cache", None)
            if warm is not None:
                warm()
            self._warmed = True
        if self.num_workers <= 0:
            it = self._iter_samples_sync(order)
        elif self.backend == "process":
            it = self._iter_samples_process(order)
        else:
            it = self._iter_samples_threaded(order)
        buf = []
        for sample in it:
            buf.append(sample if isinstance(sample, tuple) else (sample,))
            if len(buf) == self.batch_size:
                yield tuple(np.stack(col) for col in zip(*buf))
                buf = []
        if buf and not self.drop_remainder:
            yield tuple(np.stack(col) for col in zip(*buf))

    def __iter__(self):
        return self.epoch()
