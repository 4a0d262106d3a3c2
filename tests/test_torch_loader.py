"""fiery_tpu_torch.data.dataset (the host loader) against fiery_tpu.data.dataset.

Held exactly: the batch indices and bytes of both loaders over seeds, shards,
drop_last, batch sizes and repeated ``iter()`` calls with one-batch looks between
them (the JAX loop's peeks, ``for batch in loader: break``, against the port's
``peek()``); the prewarp transform's batches in 2 forkserver workers against the
prefetch thread; and ``prepare_dataloaders``' splits. The worker probe must show
no CUDA initialised and no jax imported in a worker. A loader whose batch fails
raises. The ``gpu`` case (skips without a card) checks that a loader serving the
card pins its batches.

The module imports nothing of JAX at the top, so that its ``gpu`` case runs where
JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_loader.py -m gpu
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.data.dataset import (DataLoader, _worker_backend_probe,
                                          prepare_dataloaders)
from fiery_tpu_torch.data.label_warp import make_prewarp_transform
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.utils.config import get_cfg
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

TINY = {
    'TIME_RECEPTIVE_FIELD': 2, 'N_FUTURE_FRAMES': 2, 'BATCHSIZE': 2,
    'IMAGE': {'FINAL_DIM': (32, 48), 'NAMES': ['CAM_FRONT', 'CAM_BACK']},
    'LIFT': {'X_BOUND': [-4.0, 4.0, 0.5], 'Y_BOUND': [-4.0, 4.0, 0.5],
             'D_BOUND': [2.0, 6.0, 1.0]},
    'DATASET': {'NAME': 'synthetic', 'N_SYNTHETIC_SAMPLES': 6},
}


class Indices:
    """A dataset whose sample i is {'idx': [i], 'value': [i * 0.5]}."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'idx': np.array([i], np.int64), 'value': np.array([i * 0.5], np.float32)}


class Failing(Indices):
    def __getitem__(self, i):
        if i == 3:
            raise ValueError('sample 3 is broken')
        return super().__getitem__(i)


def _jax_epochs(loader, calls):
    out = []
    for call in calls:
        if call == 'peek':
            out.append([])
            for batch in loader:
                out[-1].append(batch)
                break
        else:
            out.append(list(loader))
    return out


def _port_epochs(loader, calls):
    out = []
    for call in calls:
        if call == 'peek':
            batch = loader.peek()
            out.append([] if batch is None else [batch])
        else:
            out.append(list(loader))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch)
        for g, w in zip(g_epoch, w_epoch):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                assert g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize('n,batch_size,seed,drop_last,shuffle,shard', [
    (10, 3, 0, True, True, (0, 1)),
    (10, 3, 0, False, True, (0, 1)),
    (11, 4, 5, False, False, (0, 1)),
    (13, 2, 7, True, True, (1, 3)),
    (13, 2, 7, False, True, (2, 3)),
    (9, 9, 1, True, True, (0, 2)),
])
def test_batches_equal_jax_loader(n, batch_size, seed, drop_last, shuffle, shard):
    """The same batches in the same order, each bit for bit, through a sequence of
    epochs with looks between them (the JAX loop's DEPTH_CULL and first-batch
    peeks); also the batch indices and the loaders' lengths."""
    from fiery_tpu.data.dataset import DataLoader as JaxDataLoader
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=seed, process_index=shard[0],
              process_count=shard[1])
    ours, ref = DataLoader(Indices(n), batch_size, **kw), JaxDataLoader(Indices(n),
                                                                        batch_size, **kw)
    calls = ['peek', 'peek', 'iter', 'iter', 'peek', 'iter']
    got, want = _port_epochs(ours, calls), _jax_epochs(ref, calls)
    _assert_same(got, want)
    ours._epoch = ref._epoch = 4
    assert [list(i) for i in ours._batch_indices()] == [list(i) for i in ref._batch_indices()]
    assert len(ours) == len(got[2])                    # the shard's batches
    if shard[1] == 1:
        assert len(ours) == len(ref)


def test_synthetic_batches_equal_jax_loader_with_prewarp():
    """prepare_dataloaders' train and val splits (seeds 0 and 1000, max(2, n // 4)
    val clips) with the label prewarp: every array of every batch bit for bit."""
    from fiery_tpu.data.dataset import prepare_dataloaders as jax_prepare
    from fiery_tpu.utils.config import get_cfg as jax_get_cfg
    opts = {**TINY, 'DATASET': {**TINY['DATASET'], 'PREWARP_LABELS': True}}
    train, val = prepare_dataloaders(get_cfg(cfg_dict=opts))
    jtrain, jval = jax_prepare(jax_get_cfg(cfg_dict=opts))
    assert len(val.dataset) == len(jval.dataset) == 2 and len(train) == len(jtrain) == 3
    _assert_same(_port_epochs(train, ['peek', 'iter']), _jax_epochs(jtrain, ['peek', 'iter']))
    _assert_same(_port_epochs(val, ['iter']), _jax_epochs(jval, ['iter']))
    assert 'warped_label_stack' in next(iter(val))


def test_worker_pool_matches_in_process_and_probe():
    """num_workers=2 (forkserver) gives the prefetch thread's batches, bit for bit,
    with the prewarp transform run in the workers; the workers never initialise
    CUDA nor import jax."""
    cfg = get_cfg(cfg_dict=TINY)
    ds = SyntheticFutureDataset(cfg, n_samples=6, seed=0)
    transform = make_prewarp_transform(cfg)
    kw = dict(shuffle=True, drop_last=True, seed=7, transform=transform)
    ref_loader = DataLoader(ds, 2, num_workers=0, **kw)
    pool_loader = DataLoader(ds, 2, num_workers=2, **kw)
    try:
        want = _port_epochs(ref_loader, ['iter', 'iter'])
        got = _port_epochs(pool_loader, ['iter', 'iter'])
        _assert_same(got, want)
        assert 'warped_label_stack' in got[0][0] and len(got[0]) == 3
        probes = [pool_loader._pool.apply(_worker_backend_probe) for _ in range(4)]
        assert all(p == {'cuda_initialized': False, 'jax_imported': False}
                   for p in probes), probes
    finally:
        pool_loader.shutdown()


@pytest.mark.parametrize('num_workers', [0, 2])
def test_a_failing_batch_raises(num_workers):
    loader = DataLoader(Failing(8), 2, num_workers=num_workers)
    try:
        it = iter(loader)
        assert next(it)['idx'].ravel().tolist() == [0, 1]
        with pytest.raises(ValueError, match='sample 3'):
            list(it)
    finally:
        loader.shutdown()


def test_cpu_loaders_do_not_pin_and_other_sets_raise():
    train, val = prepare_dataloaders(get_cfg(cfg_dict=TINY), device='cpu')
    assert not train.pin_memory and not val.pin_memory
    assert isinstance(train.peek()['image'], np.ndarray)
    # an unknown set raises, as in the JAX package; nuScenes reads its tables
    with pytest.raises(ValueError, match='kitti'):
        prepare_dataloaders(get_cfg(cfg_dict={'DATASET': {'NAME': 'kitti'}}))
    with pytest.raises(FileNotFoundError, match='v1.0-trainval'):
        prepare_dataloaders(get_cfg(cfg_dict={'DATASET': {'NAME': 'nuscenes',
                                                          'DATAROOT': '/nonexistent'}}))


@pytest.mark.gpu
def test_loader_pins_batches_for_the_card():
    """A loader serving the card pins every array of every batch, and its batches
    hold the bytes of the CPU loader's."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    cfg = get_cfg(cfg_dict={**TINY, 'DATASET': {**TINY['DATASET'], 'PREWARP_LABELS': True}})
    pinned, _ = prepare_dataloaders(cfg, device='cuda')
    host, _ = prepare_dataloaders(cfg)
    got = _port_epochs(pinned, ['peek', 'iter'])
    want = _port_epochs(host, ['peek', 'iter'])
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) > 0
        for g, w in zip(g_epoch, w_epoch):
            for k, v in w.items():
                assert isinstance(g[k], torch.Tensor) and g[k].is_pinned(), k
                assert np.array_equal(g[k].numpy(), v), k
