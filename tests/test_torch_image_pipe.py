"""The port's host image pipe (fiery_tpu_torch/native) against the JAX package's
(fiery_tpu/native) and against PIL.

Held exactly: the port's pipe and JAX's on the same JPEG blobs (a fake tree's
320 x 180 frames, noise images of odd sizes; resize, crop, normalisation, the
DCT-scaled FAST_DECODE, one thread and several) give the same float32 bits, as
both compile one source. Against PIL's resize the pixels stay within 1 LSB (the
count of differing values is printed). The pipe builds into fiery_tpu_torch/build/
under a name that carries its source's hash, and never loads the JAX package's
library. A batch the pipe refuses (a file that is not a JPEG, a crop that leaves
the resized image, as lyft/baseline.yml's 400 x 225 resize under its 480-wide
crop) raises, and the dataset decodes that call with PIL, the result equal to the
JAX dataset's, counted as 'native_refused' and 'pil'; a process where the pipe
did not build decodes every image with PIL. The ``gpu`` case runs on the card's
machine (``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_image_pipe.py -m gpu``): the pipe builds or says why, and a
loader serving the card decodes with the decoder the dataset reports and pins
its batches.
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fiery_tpu_torch import native
from fiery_tpu_torch.data.dataset import prepare_dataloaders
from fiery_tpu_torch.data.fake_nuscenes import make_fake_nuscenes
from fiery_tpu_torch.data.nuscenes_dataset import build_real_datasets
from fiery_tpu_torch.utils.config import get_cfg
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def _jpeg(arr, quality=90):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='JPEG', quality=quality)
    return buf.getvalue()


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tree'))
    make_fake_nuscenes(root, n_train_scenes=1, n_val_scenes=1, n_samples=7, width=320,
                       height=180)
    return root


@pytest.fixture(scope='module')
def blobs(tree):
    cam_dir = os.path.join(tree, 'mini', 'samples', 'CAM_FRONT')
    out = []
    for name in sorted(os.listdir(cam_dir))[:4]:
        with open(os.path.join(cam_dir, name), 'rb') as f:
            out.append(f.read())
    return out


def test_pipe_builds_into_the_ports_build_dir():
    assert native.image_pipe_available(), native.build_error()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(native.__file__)), 'build')
    assert os.path.basename(path).startswith('libimage_pipe-') and os.path.exists(path)
    assert native._state['lib']._name == path


@pytest.mark.parametrize('resize,crop,fast', [
    ((128, 72), (16, 8, 112, 72), False),
    ((128, 72), (16, 8, 112, 72), True),
    ((96, 54), (0, 14, 96, 54), False),
    ((320, 180), (10, 20, 310, 170), False),
    ((160, 90), (0, 0, 160, 90), True),
])
def test_bits_equal_the_jax_pipe(blobs, resize, crop, fast):
    from fiery_tpu.native import decode_resize_crop_normalize as jax_pipe
    rng = np.random.RandomState(0)
    noise = [_jpeg(rng.randint(0, 256, (181, 323, 3), dtype=np.uint8), q) for q in (75, 95)]
    for batch, mean, std in ((blobs, MEAN, STD), (noise, MEAN, STD),
                             (blobs, np.zeros(3, np.float32), np.full(3, 1 / 255, np.float32))):
        for threads in (1, 3):
            want = jax_pipe(batch, resize, crop, mean, std, n_threads=threads, fast_scale=fast)
            got = native.decode_resize_crop_normalize(batch, resize, crop, mean, std,
                                                      n_threads=threads, fast_scale=fast)
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_within_one_lsb_of_pil(blobs):
    resize, crop = (128, 72), (16, 8, 112, 72)
    raw = native.decode_resize_crop_normalize(blobs, resize, crop, np.zeros(3, np.float32),
                                              np.full(3, 1 / 255, np.float32))
    got = np.rint(raw).astype(np.int16)
    want = np.stack([np.asarray(Image.open(io.BytesIO(b)).resize(resize, Image.BILINEAR)
                                .crop(crop), dtype=np.int16) for b in blobs])
    diff = np.abs(got - want)
    print(f'{int((diff > 0).sum())} of {diff.size} values differ from PIL by 1')
    assert diff.max() <= 1


def test_refused_batches_raise(blobs):
    with pytest.raises(RuntimeError, match='1/2 JPEGs'):
        native.decode_resize_crop_normalize([blobs[0], b'not a jpeg'], (128, 72),
                                            (16, 8, 112, 72), MEAN, STD)
    with pytest.raises(RuntimeError):
        native.decode_resize_crop_normalize(blobs[:1], (128, 72), (0, 46, 480, 270),
                                            MEAN, STD)


def test_a_refused_call_is_decoded_by_pil_as_jax_does(tree):
    from fiery_tpu.data.nuscenes_dataset import build_real_datasets as jax_build
    from fiery_tpu.utils.config import get_cfg as jax_get_cfg
    # lyft/baseline.yml's image settings over 320 x 180 frames: a 80 x 45 resize
    # and a 96-wide crop from row 9 leave the resized image, so PIL pads the crop
    d = {'IMAGE': {'ORIGINAL_WIDTH': 320, 'ORIGINAL_HEIGHT': 180, 'RESIZE_SCALE': 0.25,
                   'FINAL_DIM': (45, 96), 'TOP_CROP': 9},
         'LIFT': {'X_BOUND': [-25.0, 25.0, 1.0], 'Y_BOUND': [-25.0, 25.0, 1.0]},
         'DATASET': {'NAME': 'nuscenes', 'VERSION': 'mini', 'DATAROOT': tree}}
    ds, jds = build_real_datasets(get_cfg(cfg_dict=d))[0], jax_build(jax_get_cfg(cfg_dict=d))[0]
    got, want = ds[0], jds[0]
    assert np.array_equal(got['image'], want['image'])
    assert got['image'].shape == (7, 6, 45, 96, 3) and not got['image'][..., 80:, :].any()
    assert ds.take_decode_counts() == {'native_refused': 42, 'pil': 42}


def test_without_the_pipe_every_image_goes_through_pil(tree, monkeypatch):
    monkeypatch.setattr(native, '_state', {'lib': None, 'tried': True, 'error': 'no g++'})
    assert not native.image_pipe_available() and native.build_error() == 'no g++'
    d = {'IMAGE': {'ORIGINAL_WIDTH': 320, 'ORIGINAL_HEIGHT': 180, 'RESIZE_SCALE': 0.4,
                   'FINAL_DIM': (64, 96), 'TOP_CROP': 8},
         'DATASET': {'NAME': 'nuscenes', 'VERSION': 'mini', 'DATAROOT': tree}}
    ds = build_real_datasets(get_cfg(cfg_dict=d))[1]
    ds[0]
    assert ds.take_decode_counts() == {'pil': 42}


@pytest.mark.gpu
def test_card_loader_decodes_and_pins(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    make_fake_nuscenes(str(tmp_path), n_train_scenes=1, n_val_scenes=1, n_samples=8,
                       width=320, height=180)
    cfg = get_cfg(cfg_dict={
        'BATCHSIZE': 1, 'N_WORKERS': 2,
        'IMAGE': {'ORIGINAL_WIDTH': 320, 'ORIGINAL_HEIGHT': 180, 'RESIZE_SCALE': 0.4,
                  'FINAL_DIM': (64, 96), 'TOP_CROP': 8},
        'DATASET': {'NAME': 'nuscenes', 'VERSION': 'mini', 'DATAROOT': str(tmp_path)}})
    available = native.image_pipe_available()
    print(f'native pipe available: {available}; build error: {native.build_error()}')
    train, val = prepare_dataloaders(cfg, device='cuda')
    try:
        batch = next(iter(train))
        assert batch['image'].is_pinned() and batch['image'].dtype == torch.uint8
        # 42 images a sample; the workers may have made the next batch already
        decoder = 'native' if available else 'pil'
        assert set(train.decode_counts) == {decoder}
        assert train.decode_counts[decoder] in (42, 84)
    finally:
        train.shutdown()
        val.shutdown()
