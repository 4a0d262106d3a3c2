"""The nuScenes and Lyft loader (fiery_tpu_torch.data.nuscenes_dataset,
nuscenes_indexer, fake_nuscenes and dataset.prepare_dataloaders) against the JAX
package's, on trees that tools/make_fake_nuscenes.py writes (320 x 180 JPEGs, a
50 x 50 BEV grid).

Held exactly (np.array_equal, dtype too): every key of every window, sample for
sample: the uint8 images, intrinsics, extrinsics, the label maps, egomotion and
the sample tokens. Both sides run the same numpy and cv2 arithmetic in the same
order, so no tolerance is needed. Cases: the nuScenes mini tree (train and val)
with the native pipe and with PIL, DATASET.FAST_DECODE with each decoder,
FILTER_INVISIBLE_VEHICLES off, the Lyft tree with MODEL.SUBSAMPLE, the label
cache written by the port and read by both. The port's writer writes the JAX
tool's tables and JPEG bytes. ``prepare_dataloaders`` gives the JAX loader's
first train and val batches (numeric keys) with 0 workers, and with 2 forkserver
workers and the label prewarp, the decode counts coming back from the workers.
"""

import os
import pickle

import numpy as np
import pytest

from fiery_tpu.data.dataset import prepare_dataloaders as jax_prepare_dataloaders
from fiery_tpu.data.nuscenes_dataset import build_real_datasets as jax_build
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu_torch.data.dataset import numeric_batch, prepare_dataloaders
from fiery_tpu_torch.data.fake_nuscenes import make_fake_nuscenes
from fiery_tpu_torch.data.nuscenes_dataset import build_real_datasets
from fiery_tpu_torch.utils.config import get_cfg
from tools.make_fake_nuscenes import make_fake_nuscenes as jax_make_fake_nuscenes
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

# 320 x 180 JPEGs resized by 0.4 to 128 x 72, a 64 x 96 crop from row 8
SMALL = {'IMAGE': {'ORIGINAL_WIDTH': 320, 'ORIGINAL_HEIGHT': 180, 'RESIZE_SCALE': 0.4,
                   'FINAL_DIM': (64, 96), 'TOP_CROP': 8},
         'LIFT': {'X_BOUND': [-25.0, 25.0, 1.0], 'Y_BOUND': [-25.0, 25.0, 1.0]}}


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp('trees')
    nusc = jax_make_fake_nuscenes(str(root / 'nusc'), width=320, height=180)
    lyft = jax_make_fake_nuscenes(str(root / 'lyft'), n_train_scenes=1, n_val_scenes=1,
                                  n_samples=8, width=320, height=180, lyft=True)
    return {'nuscenes': nusc, 'lyft': lyft}


def _cfgs(tree, name='nuscenes', **extra):
    d = {**SMALL, 'DATASET': {'NAME': name, 'VERSION': 'mini', 'DATAROOT': tree,
                              **extra.pop('DATASET', {})}, **extra}
    return jax_get_cfg(cfg_dict=d), get_cfg(cfg_dict=d)


def _assert_samples_equal(want, got, where):
    assert sorted(got) == sorted(want), where
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (where, k)
        assert np.array_equal(got[k], want[k]), (where, k)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize('lyft', [False, True], ids=['nuscenes', 'lyft'])
def test_writer_writes_the_jax_tools_tables_and_jpeg_bytes(tmp_path, lyft):
    kw = dict(n_train_scenes=1, n_val_scenes=1, n_samples=3, width=160, height=90, seed=3,
              lyft=lyft)
    jax_make_fake_nuscenes(str(tmp_path / 'jax'), **kw)
    make_fake_nuscenes(str(tmp_path / 'port'), **kw)
    want, got = _files(tmp_path / 'jax'), _files(tmp_path / 'port')
    assert sorted(got) == sorted(want)
    assert sum(k.endswith('.jpg') for k in want) == 2 * 3 * 6
    assert sum(k.endswith('.json') for k in want) == 12
    for k in want:
        assert got[k] == want[k], k


# (tree, decoder, overrides, windows of the train split compared; None = all, and
# the val split too)
CASES = {
    'mini native': ('nuscenes', 'native', {}, None),
    'mini pil': ('nuscenes', 'pil', {}, [0, 5, 9]),
    'fast decode native': ('nuscenes', 'native', {'DATASET': {'FAST_DECODE': True}}, [0, 9]),
    'fast decode pil': ('nuscenes', 'pil', {'DATASET': {'FAST_DECODE': True}}, [3]),
    'invisible kept': ('nuscenes', 'native',
                       {'DATASET': {'FILTER_INVISIBLE_VEHICLES': False}}, [0, 7]),
    'lyft subsample': ('lyft', 'native', {'MODEL': {'SUBSAMPLE': True},
                                          'N_FUTURE_FRAMES': 2}, None),
}


@pytest.mark.parametrize('case', list(CASES))
def test_samples_equal_the_jax_datasets(trees, case):
    name, decoder, extra, windows = CASES[case]
    jcfg, cfg = _cfgs(trees[name], name, **extra)
    jax_sets, port_sets = jax_build(jcfg), build_real_datasets(cfg)
    splits = ('train',) if windows is not None else ('train', 'val')
    for split, jds, ds in zip(splits, jax_sets, port_sets):
        assert len(ds) == len(jds) > 0
        assert np.array_equal(ds.indices, jds.indices)
        if decoder == 'pil':
            jds._native_images = ds._native_images = False
        n_frames = 0
        for i in (range(len(ds)) if windows is None else windows):
            _assert_samples_equal(jds[i], ds[i], (case, split, i))
            n_frames += ds.sequence_length
        n_images = n_frames * len(cfg.IMAGE.NAMES)
        assert ds.take_decode_counts() == {decoder: n_images}, (case, split)
    if name == 'nuscenes':
        assert len(port_sets[0]) == 10          # mini keeps the first 10 windows
    else:
        assert port_sets[0][0]['image'].shape[0] == 3   # 5 frames subsampled ::2


def test_label_cache_round_trip(trees, tmp_path):
    cache = str(tmp_path / 'labels')
    jcfg, cfg = _cfgs(trees['nuscenes'], DATASET={'LABEL_CACHE_DIR': cache})
    jcfg_off, _ = _cfgs(trees['nuscenes'])
    ds = build_real_datasets(cfg)[0]
    jds, jds_off = jax_build(jcfg)[0], jax_build(jcfg_off)[0]
    assert ds.label_cache_dir == jds.label_cache_dir
    tokens = set()
    for i in (0, 4):
        want = jds_off[i]
        _assert_samples_equal(want, ds[i], ('written', i))      # the port writes
        _assert_samples_equal(want, ds[i], ('read', i))         # and reads
        _assert_samples_equal(want, jds[i], ('read by jax', i))
        tokens |= {ds.ixes[j]['token'] for j in ds.indices[i]}
    assert sorted(os.listdir(ds.label_cache_dir)) == sorted(f'{t}.npz' for t in tokens)


def test_index_and_dataset_pickle(trees):
    _, cfg = _cfgs(trees['nuscenes'])
    ds = build_real_datasets(cfg)[1]
    copy = pickle.loads(pickle.dumps(ds))
    assert copy.nusc.get('sample', ds.ixes[0]['token']) == ds.ixes[0]
    _assert_samples_equal(ds[1], copy[1], 'pickled')


@pytest.mark.parametrize('workers,prewarp', [(0, False), (2, True)],
                         ids=['workers0', 'workers2-prewarp'])
def test_prepare_dataloaders_first_batches_equal_jax(trees, workers, prewarp):
    opts = {'N_WORKERS': 0, 'BATCHSIZE': 2, 'DATASET': {'PREWARP_LABELS': prewarp}}
    jcfg, _ = _cfgs(trees['nuscenes'], **opts)
    _, cfg = _cfgs(trees['nuscenes'], **{**opts, 'N_WORKERS': workers})
    jax_loaders = jax_prepare_dataloaders(jcfg)
    loaders = prepare_dataloaders(cfg)
    try:
        for jloader, loader in zip(jax_loaders, loaders):
            want = numeric_batch(next(iter(jloader)))
            got = numeric_batch(next(iter(loader)))
            assert ('warped_label_stack' in got) == prewarp
            _assert_samples_equal(want, got, (workers, prewarp))
            # the images each decoder decoded, counted in the worker processes too
            assert sum(loader.decode_counts.values()) >= got['image'][:, :, :, 0, 0, 0].size
            assert set(loader.decode_counts) == {'native'}
            # the prewarp's ms, one entry a batch the loader has made so far
            assert (len(loader.transform_ms) > 0) == prewarp
            assert all(ms > 0 for ms in loader.transform_ms)
    finally:
        for loader in loaders:
            loader.shutdown()
