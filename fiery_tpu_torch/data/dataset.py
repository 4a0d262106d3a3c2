"""Host data loading: the batch iterator and the dataset dispatch (a copy of
fiery_tpu/data/dataset.py, with pinned batches for a CUDA device).

``DataLoader`` shuffles, batches, drops the last short batch, shards by process
and applies a batch-level host transform (the label prewarp of
DATASET.PREWARP_LABELS), in the same order as the JAX package's loader: a given
dataset, batch size, seed, shard and sequence of ``iter()`` calls yields the same
batches. The shuffle of an epoch is ``np.random.RandomState(seed + epoch)``, and
the epoch counter advances on every ``iter()`` and ``peek()``, a one-batch look
included.

Where the batches are made: with ``num_workers > 0`` in a forkserver pool of
worker processes (the transform too), else in a prefetch thread of the calling
process; never on the thread that runs the steps. The workers import torch but
never initialise CUDA: the card belongs to the parent process. With
``pin_memory`` (a loader that serves a CUDA device) the loader's thread in the
parent process pins each batch's numeric arrays, so that ``Trainer.to_device``
copies them with ``non_blocking=True``; the batch then holds CPU tensors in
pinned memory in place of those arrays.

Datasets: 'synthetic' (in memory, no external data), and 'nuscenes' and 'lyft'
(``data/nuscenes_dataset.py``: the JSON tables and JPEGs under DATASET.DATAROOT,
in cfg.N_WORKERS workers). Each batch's load reports what it measured: the
images each decoder decoded (``decode_counts``, summed over the workers) and the
ms of the batch transform (``transform_ms``, a list, one entry a transformed
batch); ``pool_start_s`` is the seconds the worker pool took to start and answer
a first task.
"""

import multiprocessing as mp
import os
import queue as queue_mod
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch

from fiery_tpu_torch.data.label_warp import make_prewarp_transform
from fiery_tpu_torch.data.nuscenes_dataset import build_real_datasets
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset

_WORKER_DATASET = None
_WORKER_TRANSFORM = None


def _worker_init(dataset, transform=None):
    global _WORKER_DATASET, _WORKER_TRANSFORM
    _WORKER_DATASET = dataset
    _WORKER_TRANSFORM = transform


def load_batch(dataset, idx, transform=None):
    """(batch, report): the samples ``idx`` of ``dataset`` stacked into one numpy
    batch, then the transform; and what the load measured: the images each
    decoder decoded (datasets with ``take_decode_counts``) and the ms of the
    transform (None without one)."""
    samples = [dataset[int(i)] for i in idx]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    transform_ms = None
    if transform is not None:
        t0 = time.perf_counter()
        batch = transform(batch)
        transform_ms = 1e3 * (time.perf_counter() - t0)
    take = getattr(dataset, 'take_decode_counts', None)
    return batch, {'decode_counts': take() if take else Counter(),
                   'transform_ms': transform_ms}


def _worker_load(idx):
    return load_batch(_WORKER_DATASET, idx, _WORKER_TRANSFORM)


def _main_module_name():
    """[the name under which the forkserver can import the main module], or [].

    Each worker runs the main module again as ``__mp_main__`` (the reason for the
    ``__main__`` guard), and Python 3.12's forkserver does not preload it (its
    ``'__main__'`` preload never receives the main path), so every worker would
    import what the main module imports: torch and the model for the training
    CLI, ~10 s a worker on a shared host. Imported once in the server by its
    name, the main module's imports are loaded in every worker forked from it.
    A ``-m`` module is importable by its spec's name, a script by its file's
    stem (its directory leads ``sys.path``, which the server copies)."""
    main = sys.modules.get('__main__')
    spec = getattr(main, '__spec__', None)
    if spec is not None:
        return [] if spec.name.endswith('__main__') else [spec.name]
    path = getattr(main, '__file__', None)
    if path is None or not path.endswith('.py'):
        return []
    return [os.path.splitext(os.path.basename(path))[0]]


def _worker_backend_probe(_=None):
    """What a worker process holds of the accelerator stacks: whether it
    initialised CUDA and whether it imported jax. Workers stay on the host: the
    card belongs to the parent process, and a worker that claims it can hang the
    pool (the JAX package saw that with a worker that initialised its backend)."""
    return {'cuda_initialized': torch.cuda.is_initialized(),
            'jax_imported': 'jax' in sys.modules}


def pin_batch(batch):
    """Numeric numpy arrays -> CPU tensors in pinned memory; other entries as they
    are."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            if isinstance(v, np.ndarray) and v.dtype.kind in 'biuf' else v
            for k, v in batch.items()}


class DataLoader:
    """Shuffling, batching, drop_last, per-process shards, a batch transform and
    background prefetch.

    Several processes: pass (process_index, process_count) to have each read a
    disjoint strided shard of every (deterministically shuffled) epoch.

    num_workers > 0 uses a forkserver pool, so the usual multiprocessing rules
    apply: the calling script needs an ``if __name__ == '__main__'`` guard, and a
    script piped through stdin cannot start workers. The pool pings a worker when
    it starts, so that such a set-up fails at once instead of respawning workers
    forever. A batch that fails to load, in a worker or in the prefetch thread,
    raises from the iterator.
    """

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False, seed=0,
                 prefetch=4, num_workers=0, process_index=0, process_count=1,
                 transform=None, pin_memory=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = process_count
        self.transform = transform
        self.pin_memory = pin_memory
        self.decode_counts = Counter()
        self.transform_ms = []
        self.pool_start_s = None
        self._epoch = 0
        self._pool = None

    def _get_pool(self):
        if self._pool is None and self.num_workers > 0:
            # forkserver, not fork: the parent runs CUDA and autograd threads, and
            # forking a multithreaded process can deadlock; forkserver workers fork
            # from a clean server process and get the dataset and transform by pickle
            ctx = mp.get_context('forkserver')
            # the server imports the loader's modules and the main module's once,
            # so that each worker forks with them loaded
            ctx.set_forkserver_preload([__name__, *_main_module_name()])
            t0 = time.perf_counter()
            self._pool = ctx.Pool(self.num_workers, initializer=_worker_init,
                                  initargs=(self.dataset, self.transform))
            try:
                self._pool.apply_async(int, (0,)).get(timeout=120)
            except Exception as e:
                self._pool.terminate()
                self._pool = None
                raise RuntimeError(
                    'data-loader worker pool failed its startup ping: workers are '
                    'dying on arrival (an unpicklable dataset or transform, or a '
                    '__main__ module that a forkserver child cannot import, as from '
                    'stdin). Use num_workers=0 in that case.') from e
            self.pool_start_s = time.perf_counter() - t0
        return self._pool

    def shutdown(self):
        """Drain and close the worker pool (close and join, so that queued work
        finishes)."""
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None

    def __len__(self):
        n = len(self.dataset)
        if self.process_count > 1:
            n = len(range(self.process_index, n, self.process_count))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            # the same permutation in every process; each takes a strided shard
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        if self.process_count > 1:
            order = order[self.process_index::self.process_count]
            n = len(order)
        batches = []
        for i in range(0, n, self.batch_size):
            idx = order[i:i + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                continue
            batches.append(idx)
        return batches

    def _finish(self, measured):
        batch, report = measured
        self.decode_counts.update(report['decode_counts'])
        if report['transform_ms'] is not None:
            self.transform_ms.append(report['transform_ms'])
        return pin_batch(batch) if self.pin_memory else batch

    def peek(self):
        """The first batch of a new epoch (None if the epoch has none), made on the
        calling thread; advances the epoch counter as ``iter()`` followed by one
        ``next()`` does."""
        self._epoch += 1
        batches = self._batch_indices()
        if not batches:
            return None
        return self._finish(load_batch(self.dataset, batches[0], self.transform))

    def __iter__(self):
        self._epoch += 1
        batches = self._batch_indices()
        pool = self._get_pool()
        if pool is not None:
            # the workers make and transform the batches; this thread pins them
            source = pool.imap(_worker_load, batches)
        else:
            source = (load_batch(self.dataset, idx, self.transform)
                      for idx in batches)
        q = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def producer():
            try:
                for measured in source:
                    if not put((None, self._finish(measured))):
                        return
            except Exception as e:           # raised again on the consuming thread
                put((e, None))
                return
            put((None, done))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                error, item = q.get()
                if error is not None:
                    raise error
                if item is done:
                    return
                yield item
        finally:
            stop.set()
            thread.join()


def numeric_batch(batch):
    """Drop non-numeric entries (e.g. 'sample_token' strings) from a stacked batch."""
    return {k: v for k, v in batch.items()
            if isinstance(v, torch.Tensor) or np.asarray(v).dtype.kind in 'biufc'}


def prepare_dataloaders(cfg, device=None, batch_size=None, process_index=0, process_count=1):
    """(train_loader, val_loader) for the configured dataset: train shuffled with
    drop_last, val in order, batches of ``batch_size`` (cfg.BATCHSIZE when None).
    The loaders pin their batches when ``device`` is a CUDA device; with device
    None or the CPU they yield numpy batches. Several processes (data-parallel
    ranks): (process_index, process_count) has each read a disjoint strided shard
    of every (identically shuffled) epoch, as the JAX package's loaders do."""
    name = cfg.DATASET.NAME
    if name == 'synthetic':
        n_train = cfg.DATASET.N_SYNTHETIC_SAMPLES
        train_ds = SyntheticFutureDataset(cfg, n_samples=n_train, seed=0)
        val_ds = SyntheticFutureDataset(cfg, n_samples=max(2, n_train // 4), seed=1000)
    elif name in ('nuscenes', 'lyft'):
        train_ds, val_ds = build_real_datasets(cfg)
    else:
        raise ValueError(f'Unknown dataset {name}')
    num_workers = cfg.N_WORKERS if name in ('nuscenes', 'lyft') else 0
    transform = make_prewarp_transform(cfg) if cfg.DATASET.PREWARP_LABELS else None
    pin = device is not None and torch.device(device).type == 'cuda'
    kw = dict(num_workers=num_workers, transform=transform, pin_memory=pin,
              process_index=process_index, process_count=process_count)
    bs = cfg.BATCHSIZE if batch_size is None else batch_size
    train_loader = DataLoader(train_ds, bs, shuffle=True, drop_last=True, **kw)
    val_loader = DataLoader(val_ds, bs, shuffle=False, drop_last=False, **kw)
    return train_loader, val_loader
