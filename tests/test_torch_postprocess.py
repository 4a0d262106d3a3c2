"""fiery_tpu_torch.postprocess.instance against fiery_tpu.postprocess.instance (the JAX
reference) on the CPU: centre NMS + top-k (K6), pixel grouping and relabel (K7), the
centroids (K8), the device and host trackers, the decode, and the whole tiny forward
through predict_instances. Integer outputs must be equal. The kernels against their
plain versions on the card: tests/test_torch_decode_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evaluate import _device_consistent
from fiery_tpu.postprocess import instance as JI
from fiery_tpu_torch.postprocess import instance as I
from fiery_tpu_torch.serve import predict_instances
from test_torch_fiery import jax_tiny_model, ported_tiny_model, tiny_request


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_device_consistent(output):
    """evaluate._device_consistent under a fresh jit: re-running one jitted function
    object on new inputs trips a stale-executable fastpath in this jax build (see
    tests/test_postprocess.py)."""
    return np.asarray(jax.jit(lambda o: _device_consistent.__wrapped__(o))(output))


def peak_heatmap(rng, h, w, values):
    """Isolated single-pixel peaks with the given values at random sites of a
    stride-2 lattice (so no two share a 3x3 window); 0 elsewhere."""
    sites = [(i, j) for i in range(0, h, 2) for j in range(0, w, 2)]
    hm = np.zeros((h, w), np.float32)
    for site, v in zip(rng.permutation(len(sites))[:len(values)], values):
        hm[sites[site]] = v
    return hm


def tie_case_heatmaps():
    """The score patterns of tests/test_postprocess.py's top-k tie cases, at 64 x 64:
    sparse random peaks, heavy ties at 3 values (ties across the 100th slot), an empty
    map and a single peak; plus smooth maps quantised to 3 levels, whose plateaus
    make runs of equal neighbouring peaks."""
    rng = np.random.RandomState(0)
    h = w = 64
    maps = []
    for _ in range(2):
        n = rng.randint(0, 300)
        maps.append(peak_heatmap(rng, h, w, rng.rand(n).astype(np.float32) + 0.1))
    for _ in range(2):
        maps.append(peak_heatmap(rng, h, w, rng.choice([0.25, 0.5, 0.75], 250)))
    maps.append(np.zeros((h, w), np.float32))
    maps.append(peak_heatmap(rng, h, w, [0.9]))
    for _ in range(2):
        smooth = rng.rand(h // 4, w // 4).repeat(4, 0).repeat(4, 1)
        maps.append((np.floor(smooth * 3) / 3 + 0.05).astype(np.float32))
    return np.stack(maps)


def random_outputs(seed, b=1, s=3, h=40, w=48, n_classes=2):
    """A network output dict (numpy, channels-last) with dense random heads."""
    rng = np.random.RandomState(seed)
    return {
        'segmentation': rng.randn(b, s, h, w, n_classes).astype(np.float32),
        'instance_center': rng.rand(b, s, h, w, 1).astype(np.float32),
        'instance_offset': (rng.randn(b, s, h, w, 2) * 4.0).astype(np.float32),
        'instance_flow': rng.randn(b, s, h, w, 2).astype(np.float32),
    }


@pytest.mark.parametrize('mode', ['nosort', 'topk'])
def test_find_instance_centers_bit_equal(monkeypatch, mode):
    monkeypatch.setattr(JI, '_DECODE_TOPK', mode)
    maps = tie_case_heatmaps()
    got_c, got_v = I.find_instance_centers(t(maps))
    for f, hm in enumerate(maps):
        want_c, want_v = JI.find_instance_centers(jnp.asarray(hm))
        np.testing.assert_array_equal(got_c[f].numpy(), np.asarray(want_c), err_msg=str(f))
        np.testing.assert_array_equal(got_v[f].numpy(), np.asarray(want_v), err_msg=str(f))


@pytest.mark.parametrize('seed', [0, 1])
def test_find_instance_centers_random_heatmaps(seed):
    rng = np.random.RandomState(seed)
    maps = rng.rand(3, 50, 30).astype(np.float32) ** 3
    got_c, got_v = I.find_instance_centers(t(maps), conf_threshold=0.2, nms_kernel_size=5,
                                           max_instances=40)
    for f in range(3):
        want_c, want_v = JI.find_instance_centers(jnp.asarray(maps[f]), 0.2, 5, 40)
        np.testing.assert_array_equal(got_c[f].numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_v[f].numpy(), np.asarray(want_v))


def test_group_pixels_and_relabel_bit_equal():
    rng = np.random.RandomState(2)
    maps = tie_case_heatmaps()[[0, 2, 4, 6]]
    offset = (rng.randn(4, 64, 64, 2) * 6.0).astype(np.float32)
    centers, valid = I.find_instance_centers(t(maps))
    got = I.group_pixels(centers, valid, t(offset)).numpy()
    for f in range(4):
        want = JI.group_pixels(jnp.asarray(centers[f].numpy()), jnp.asarray(valid[f].numpy()),
                               jnp.asarray(offset[f]))
        np.testing.assert_array_equal(got[f], np.asarray(want))
    seg = rng.randint(0, 101, size=(3, 50, 50)).astype(np.int32)
    seg[seg % 3 == 0] = 0
    got = I.make_instance_seg_consecutive(t(seg)).numpy()
    for f in range(3):
        np.testing.assert_array_equal(got[f], np.asarray(JI.make_instance_seg_consecutive(
            jnp.asarray(seg[f]))))


def test_get_instance_segmentation_and_centers_bit_equal():
    rng = np.random.RandomState(4)
    center = rng.rand(3, 40, 40, 1).astype(np.float32) ** 2
    offset = (rng.randn(3, 40, 40, 2) * 3.0).astype(np.float32)
    fg = rng.rand(3, 40, 40) < 0.6
    fg[2] = False
    center[1] = 0.0                      # no valid centre: every pixel background
    seg, centers, valid = I.get_instance_segmentation_and_centers(t(center), t(offset), t(fg))
    for f in range(3):
        w_seg, w_c, w_v = JI.get_instance_segmentation_and_centers(
            jnp.asarray(center[f]), jnp.asarray(offset[f]), jnp.asarray(fg[f]))
        np.testing.assert_array_equal(seg[f].numpy(), np.asarray(w_seg))
        np.testing.assert_array_equal(centers[f].numpy(), np.asarray(w_c))
        np.testing.assert_array_equal(valid[f].numpy(), np.asarray(w_v))


@pytest.mark.parametrize('seed,n_classes,vehicles_id', [(5, 2, 1), (6, 4, 2)])
def test_decode_instance_predictions_bit_equal(seed, n_classes, vehicles_id):
    out = random_outputs(seed, b=2, n_classes=n_classes)
    want = JI.decode_instance_predictions({k: jnp.asarray(v) for k, v in out.items()},
                                          vehicles_id=vehicles_id)
    got = I.decode_instance_predictions({k: t(v) for k, v in out.items()},
                                        vehicles_id=vehicles_id)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 40, 48)
    assert int(got.max()) > 10
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('with_flow', [False, True])
def test_segment_centroids_equal_f64_bincount(with_flow):
    """The plain centroids are the host tracker's f64 bincount centroids rounded
    once to f32; ids outside [0, num_slots) are dropped."""
    rng = np.random.RandomState(7)
    labels = rng.randint(-1, 30, size=(2, 33, 41)).astype(np.int32)
    flow = (rng.randn(2, 33, 41, 2) * 3).astype(np.float32)
    centers, valid = I.segment_centroids(t(labels), 25, t(flow) if with_flow else None)
    grid = np.stack(np.meshgrid(np.arange(33, dtype=np.float32),
                                np.arange(41, dtype=np.float32), indexing='ij'))
    for b in range(2):
        coords = grid + np.moveaxis(flow[b], -1, 0) if with_flow else grid
        lab = labels[b]
        present = np.unique(lab[(lab >= 0) & (lab < 25)])
        want = JI._segment_centroids(np.where(lab >= 0, lab, 99), coords, present)
        np.testing.assert_array_equal(centers[b, present].numpy(), want.astype(np.float32))
        np.testing.assert_array_equal(valid[b].numpy(), np.isin(np.arange(25), present))
        assert (centers[b][~valid[b]] == 0).all()


def moving_scene(s=3, h=32, w=32):
    pred_inst = np.zeros((s, h, w), np.int32)
    flow = np.zeros((s, h, w, 2), np.float32)
    for t_ in range(s):
        a_id, b_id = (1, 2) if t_ % 2 == 0 else (2, 1)
        pred_inst[t_, 10:14, 4 + 4 * t_: 8 + 4 * t_] = a_id
        pred_inst[t_, 24:28, 24:28] = b_id
        flow[t_, 10:14, :, 1] = 4.0
    return pred_inst, flow


def new_instance_scene():
    pred_inst = np.zeros((2, 32, 32), np.int32)
    pred_inst[0, 4:8, 4:8] = 1
    pred_inst[1, 4:8, 4:8] = 1
    pred_inst[1, 20:24, 20:24] = 2
    return pred_inst, np.zeros((2, 32, 32, 2), np.float32)


def random_scene(rng, s=4, h=48, w=48):
    n_inst = rng.randint(3, 8)
    base = rng.randint(6, h - 10, size=(n_inst, 2))
    vel = rng.randint(-3, 4, size=(n_inst, 2))
    pred_inst = np.zeros((s, h, w), np.int32)
    flow = np.zeros((s, h, w, 2), np.float32)
    for t_ in range(s):
        perm = rng.permutation(n_inst)
        for local_id, k in enumerate(perm, start=1):
            x = int(np.clip(base[k, 0] + vel[k, 0] * t_, 0, h - 5))
            y = int(np.clip(base[k, 1] + vel[k, 1] * t_, 0, w - 5))
            pred_inst[t_, x:x + 4, y:y + 4] = local_id
            flow[t_, x:x + 4, y:y + 4] = vel[k]
    return pred_inst, flow


def crowded_scene(s=3, h=120, w=120, n=60):
    """60 ids in frame 0, 60 fresh ones in frame 1 (ids past 100) re-matched in frame 2."""
    pred_inst = np.zeros((s, h, w), np.int32)
    k = 0
    for i in range(0, h, 12):
        for j in range(0, w, 12):
            if k >= n:
                break
            pred_inst[0, i:i + 3, j:j + 3] = k + 1
            pred_inst[1:, i + 6:i + 9, j + 6:j + 9] = k + 1
            k += 1
    return pred_inst, np.zeros((s, h, w, 2), np.float32)


def tracker_scenes():
    rng = np.random.RandomState(7)
    return ([('moving', *moving_scene()), ('new', *new_instance_scene())]
            + [(f'random{i}', *random_scene(rng)) for i in range(5)]
            + [('crowded', *crowded_scene())])


@pytest.mark.parametrize('name,pred_inst,flow', tracker_scenes(),
                         ids=[n for n, _, _ in tracker_scenes()])
def test_device_tracker_equals_jax(name, pred_inst, flow):
    want = np.asarray(jax.jit(
        lambda p, f: JI.make_instance_id_temporally_consistent_device(p, f))(
            jnp.asarray(pred_inst), jnp.asarray(flow)))
    got = I.make_instance_id_temporally_consistent_device(t(pred_inst)[None], t(flow)[None])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want)
    if name == 'crowded':
        assert int(got.max()) > 100


@pytest.mark.parametrize('name,pred_inst,flow', tracker_scenes(),
                         ids=[n for n, _, _ in tracker_scenes()])
def test_host_tracker_equals_jax(name, pred_inst, flow):
    want = JI.make_instance_id_temporally_consistent(pred_inst[None].astype(np.int64),
                                                     flow[None])
    got = I.make_instance_id_temporally_consistent(pred_inst[None].astype(np.int64),
                                                   flow[None])
    np.testing.assert_array_equal(got, want)


def moving_box_output():
    """The scene of tests/test_postprocess.py's postprocessing test (b=1, s=2): one
    box moving 4 px."""
    h = w = 32
    seg_logits = np.zeros((1, 2, h, w, 2), np.float32)
    center = np.zeros((1, 2, h, w, 1), np.float32)
    offset = np.zeros((1, 2, h, w, 2), np.float32)
    flow = np.zeros((1, 2, h, w, 2), np.float32)
    x, y = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                       indexing='ij')
    for t_, cx in enumerate([8, 12]):
        mask = (np.abs(x - cx) < 3) & (np.abs(y - 16) < 3)
        seg_logits[0, t_, :, :, 1] = np.where(mask, 5.0, -5.0)
        seg_logits[0, t_, :, :, 0] = -seg_logits[0, t_, :, :, 1]
        center[0, t_, :, :, 0] = np.exp(-((x - cx) ** 2 + (y - 16) ** 2) / 4.0)
        offset[0, t_, ..., 0][mask] = (cx - x)[mask]
        offset[0, t_, ..., 1][mask] = (16 - y)[mask]
        flow[0, t_, :, :, 0] = 4.0
    return {'segmentation': seg_logits, 'instance_center': center,
            'instance_offset': offset, 'instance_flow': flow}


@pytest.mark.parametrize('scene', ['moving_box', 'random'])
def test_host_postprocessing_equals_jax(scene):
    out = moving_box_output() if scene == 'moving_box' else random_outputs(8, s=4)
    want = JI.predict_instance_segmentation_and_trajectories(
        {k: jnp.asarray(v) for k, v in out.items()}, compute_matched_centers=True)
    got = I.predict_instance_segmentation_and_trajectories(
        {k: t(v) for k, v in out.items()}, compute_matched_centers=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])
    if scene == 'moving_box':
        assert set(np.unique(got[0])) == {0, 1}


@pytest.mark.parametrize('seed', [9, 10])
def test_device_consistent_equals_jax(seed):
    """Decode + device tracker on random dense heads (every frame's 100 slots full)."""
    from fiery_tpu_torch.evaluate import device_consistent
    out = random_outputs(seed, b=2, s=4, h=36, w=36)
    want = jax_device_consistent({k: jnp.asarray(v) for k, v in out.items()})
    got = device_consistent({k: t(v) for k, v in out.items()})
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope='module')
def tiny_models():
    jcfg, jmodel, variables = jax_tiny_model()
    return jmodel, variables, ported_tiny_model(variables)


def test_predict_instances_tiny_forward_equals_jax(tiny_models):
    """The tiny forward end to end: JAX forward + _device_consistent against the
    port's predict_instances on a CPU model, device and host matching. The port's
    own forward output through the JAX decode must give the same ids too."""
    jmodel, variables, model = tiny_models
    image, intr, extr, ego = tiny_request(1)
    request = {'image': image, 'intrinsics': intr, 'extrinsics': extr,
               'future_egomotion': ego}
    jout = jax.jit(lambda v, *a: jmodel.apply(v, *a, None, train=False))(
        variables, image, intr, extr, ego)
    want = jax_device_consistent(jout)
    output, got = predict_instances(model, request)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert int(got.max()) > 1
    np.testing.assert_array_equal(got.numpy(), want)
    on_port_output = jax_device_consistent(
        {k: jnp.asarray(v.numpy()) for k, v in output.items()})
    np.testing.assert_array_equal(got.numpy(), on_port_output)
    _, host = predict_instances(model, request, device_matching=False)
    want_host = JI.predict_instance_segmentation_and_trajectories(jout)
    np.testing.assert_array_equal(host.numpy(), want_host)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors run the plain versions without counting a launch; a device that is
    neither the CPU nor CUDA raises."""
    counters = (I.find_instance_centers, I.instance_ids, I.segment_centroids)
    before = [f.launches for f in counters]
    I.decode_instance_predictions({k: t(v) for k, v in random_outputs(11).items()})
    I.segment_centroids(torch.zeros(1, 4, 4, dtype=torch.int32), 3)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError):
        I.find_instance_centers(torch.zeros(1, 8, 8, device='meta'))
    with pytest.raises(ValueError):
        I.segment_centroids(torch.zeros(1, 8, 8, dtype=torch.int32, device='meta'), 3)
    with pytest.raises(ValueError):
        I.instance_ids(torch.zeros(1, 4, 2, dtype=torch.int32, device='meta'),
                       torch.zeros(1, 4, dtype=torch.bool, device='meta'),
                       torch.zeros(1, 8, 8, 2, device='meta'),
                       torch.zeros(1, 8, 8, 2, device='meta'))
