"""The port's lever accuracy study (fiery_tpu_torch/accuracy_ab.py and
accuracy_report.py) against the JAX harness (tools/accuracy_ab.py and
tools/accuracy_report.py), on the CPU at the harness's own width (BASE).

- (a) BASE, MODES, N_TRAIN and N_VAL equal the harness's, read from its source with
  ``ast``: importing it would set JAX's platform and a compilation cache.
- (b) A JAX Trainer state (He weights drawn for the JAX model's shapes, unit
  BatchNorm; the depth head's kernel scaled so that its softmax spreads, and the
  vehicle logit's bias raised so that about half of a clip's pixels are vehicles) carried into the port by
  ``state_dict_from_jax``: on the validation clips the port's eval heads lie within
  1e-4 relative L2 of JAX's ``eval_step`` under dense and topk8_warpfree, and
  ``evaluate_state``'s IoU and VPQ within 1e-3 of JAX's, computed with the JAX
  package's decode, tracker and metrics as the harness computes them.
- (c) ``_depth_stats``' entropy and top-8 mass within 1e-5 of JAX's bare Encoder.
- (d) ``_bev_features`` under dense, topk8 and warpfree within 1e-5 of the dense
  features' largest magnitude of JAX's ``model.apply(method=bev)``.
- (e) The training clips of each step are the harness's draws, for seeds 0-2.
- (f) A 2-step train study on the CPU (1 seed, --n-train 4) writes a JSON with the
  keys and nesting of reports/accuracy_ab_train_r5.json plus ``device``, and the
  port's report prints for it what tools/accuracy_report.py prints.

Every JAX computation of (b)-(d) runs in one jit of a module fixture.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.models.encoder import Encoder as JaxEncoder
from fiery_tpu.models.fiery import _IMAGENET_MEAN, _IMAGENET_STD
from fiery_tpu.ops.warp import cumulative_warp_features as jax_cumulative_warp_features
from fiery_tpu.postprocess.instance import (
    predict_instance_segmentation_and_trajectories as jax_trajectories)
from fiery_tpu.training.metrics import IntersectionOverUnion, PanopticMetric
from fiery_tpu.training.trainer import Trainer as JaxTrainer
from fiery_tpu.training.trainer import TrainState
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu_torch import accuracy_ab as ab
from fiery_tpu_torch import accuracy_report
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.weight_import import state_dict_from_jax
from torch_family import dataclasses_equal, he_variables, variable_shapes
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(REPO, 'tools', 'accuracy_ab.py')
HEADS = ('segmentation', 'instance_center', 'instance_offset', 'instance_flow')


def _harness_constants():
    """BASE, MODES, N_TRAIN and N_VAL as tools/accuracy_ab.py assigns them."""
    with open(HARNESS) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target, value = node.targets[0], node.value
        if isinstance(target, ast.Name) and target.id in ('BASE', 'MODES'):
            out[target.id] = ast.literal_eval(value)
        elif isinstance(target, ast.Tuple):
            names = [t.id for t in target.elts]
            if names == ['N_TRAIN', 'N_VAL']:
                out.update(zip(names, ast.literal_eval(value)))
    return out


def test_the_study_constants_are_the_harness_s():
    assert _harness_constants() == {'BASE': ab.BASE, 'MODES': ab.MODES,
                                    'N_TRAIN': ab.N_TRAIN, 'N_VAL': ab.N_VAL}
    assert ab.N_TRAIN == 16 and ab.N_VAL == 8


def test_merge_copies_and_leaves_base_alone():
    """The port's ``_merge`` merges nested dicts at any depth into a copy: BASE
    keeps no key of a mode after the mode's config is made."""
    before = json.dumps(ab.BASE, sort_keys=True)
    merged = ab._merge(ab.BASE, ab.MODES['all'])
    assert merged['MODEL']['TEMPORAL_MODEL'] == {'START_OUT_CHANNELS': 24, 'TRIM_TRAIN': True}
    assert merged['LIFT']['TOPK'] == 8 and merged['LIFT']['D_BOUND'] == [2.0, 26.0, 1.0]
    assert json.dumps(ab.BASE, sort_keys=True) == before


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_training_draws_are_the_harness_s(seed):
    steps, batch = 40, ab.BASE['BATCHSIZE']
    order = np.random.RandomState(7 + 1000 * seed)
    want = [order.choice(ab.N_TRAIN, size=batch, replace=False) for _ in range(steps)]
    got = ab.train_indices(seed, steps, ab.N_TRAIN, batch)
    assert got.shape == (steps, batch) and got.dtype == np.int64
    np.testing.assert_array_equal(got, np.stack(want))


# ---- the port against the JAX package on one state ----

def _jax_bev(m, image, intrinsics, extrinsics, ego):
    """tools/accuracy_ab.py ``_bev_features``' method: the present-frame BEV
    features of a serving config."""
    c = m.cfg
    rf = c.receptive_field
    image = ((image[:, :rf].astype(jnp.float32) / 255.0 - _IMAGENET_MEAN)
             / _IMAGENET_STD).astype(c.compute_dtype)
    ego_in = ego[:, :rf]
    x = m.calculate_birds_eye_view_features(image, intrinsics[:, :rf], extrinsics[:, :rf],
                                            False, egomotion=ego_in if c.warp_free else None)
    if not c.warp_free:
        x = jax_cumulative_warp_features(x, ego_in, mode='bilinear',
                                         spatial_extent=c.spatial_extent)
    return x


def _jax_depth(jtrainer, variables, image):
    """tools/accuracy_ab.py ``_depth_stats``' encoder: the bare Encoder on the model's
    encoder subtree, over the receptive field's normalised images."""
    c = jtrainer.model_cfg
    enc = JaxEncoder(out_channels=c.encoder_out_channels, depth_channels=c.depth_channels,
                     version=c.encoder_name.split('-')[1], downsample=c.encoder_downsample,
                     use_depth_distribution=c.use_depth_distribution,
                     bn_momentum=c.bn_momentum, dtype=c.compute_dtype)
    img = image[:, :c.receptive_field]
    b, s, n = img.shape[:3]
    img = ((img.reshape(b * s * n, *img.shape[3:]).astype(jnp.float32) / 255.0
            - _IMAGENET_MEAN) / _IMAGENET_STD).astype(c.compute_dtype)
    depth, _ = enc.apply({'params': variables['params']['bev_lift']['encoder'],
                          'batch_stats': variables['batch_stats']['bev_lift']['encoder']},
                         img, False, True)
    return depth


@pytest.fixture(scope='module')
def study():
    """One state in both packages, the port's val clips and activation batch, and
    every JAX output of (b)-(d) from one jit: the eval heads and labels of the 8
    clips stacked, under dense and topk8_warpfree; the BEV features under dense,
    topk8 and warpfree and the encoder's depth on the activation batch."""
    cfg = ab._cfg({})
    trainers = {m: JaxTrainer(jax_get_cfg(cfg_dict=ab._merge(ab.BASE, ab.MODES[m])))
                for m in ('dense', 'topk8', 'warpfree', 'topk8_warpfree')}
    port = Trainer(cfg, device='cpu')
    mc = port.model.cfg
    assert dataclasses_equal(mc, trainers['dense'].model_cfg)
    val = ab._val_batches(cfg, torch.device('cpu'))
    act = ab._to_device(ab.SyntheticFutureDataset(cfg, n_samples=2, n_instances=3,
                                                  seed=1000).get_batch([0, 1]), 'cpu')
    stacked = {k: jnp.asarray(np.concatenate([b[k].numpy() for b in val])) for k in val[0]}
    inputs = [jnp.asarray(act[k].numpy()) for k in
              ('image', 'intrinsics', 'extrinsics', 'future_egomotion')]
    variables = he_variables(variable_shapes(trainers['dense'].model, cfg, mc), seed=4)
    uncertainty = {k: np.float32(0.0) for k in port.uncertainty}

    def port_state():
        return {'model': state_dict_from_jax(variables, mc),
                'uncertainty': {k: torch.tensor(v) for k, v in uncertainty.items()}, 'step': 0}

    # the depth logits spread to a median sd of 1 over the bins (the drawn backbone's
    # depthwise convolutions shrink the features, and the head's softmax is uniform:
    # its top-8 bins would be ties), and the vehicle logit's bias raised by the
    # median margin of the background's on the first clip, so that about half its
    # pixels are vehicles and IoU is not 0
    model = ab._loaded(port_state(), {}, torch.device('cpu')).model.eval()
    img = act['image'][:, :mc.receptive_field]
    with torch.no_grad():
        depth, _ = model.encoder(ab._normalise(model, img.reshape(-1, *img.shape[3:])))
    spread = float(torch.log(depth.double()).std(-1).median())
    variables['params']['bev_lift']['encoder']['depth_layer']['kernel'] *= np.float32(
        1.0 / spread)
    logits = ab._head_outputs(port_state(), {}, val[0])['segmentation'].double()
    variables['params']['decoder']['heads']['out_0']['bias'][1] += np.float32(
        float((logits[..., 0] - logits[..., 1]).median()))
    state = port_state()

    def reference(variables, stacked, inputs):
        jstate = TrainState(step=jnp.zeros((), jnp.int32),
                            params={'model': variables['params'], 'uncertainty': uncertainty},
                            batch_stats=variables['batch_stats'], opt_state=None)
        heads = {}
        for mode in ('dense', 'topk8_warpfree'):
            output, labels, _ = trainers[mode].eval_step(jstate, stacked)
            heads[mode] = ({k: output[k] for k in HEADS},
                           labels['segmentation'], labels['instance'])
        bev = {mode: trainers[mode].model.apply(variables, *inputs, method=_jax_bev)
               for mode in ('dense', 'topk8', 'warpfree')}
        return heads, bev, _jax_depth(trainers['dense'], variables, inputs[0])

    heads, bev, depth = jax.tree.map(np.asarray, jax.jit(reference)(variables, stacked, inputs))
    return dict(state=state, val=val, act=act, heads=heads, bev=bev, depth=depth)


def _jax_scores(output, seg_label, instance):
    """tools/accuracy_ab.py ``evaluate_state``'s metrics of JAX outputs (all clips at
    once: the metrics add up each clip's counts, and the tracker runs clip by
    clip)."""
    iou, pan = IntersectionOverUnion(2), PanopticMetric(2)
    seg_pred = np.argmax(output['segmentation'], -1).astype(np.uint8)
    consistent = jax_trajectories({k: jnp.asarray(v) for k, v in output.items()})
    iou.update(seg_pred.astype(np.int32), seg_label.astype(np.uint8).astype(np.int32))
    pan.update(np.asarray(consistent).astype(np.int32),
               instance.astype(np.int16).astype(np.int32))
    return {'iou': float(iou.compute()[1]), 'vpq': float(pan.compute()['pq'][1])}


@pytest.mark.parametrize('mode', ['dense', 'topk8_warpfree'])
def test_eval_heads_and_scores_match_jax(study, mode):
    want, seg_label, instance = study['heads'][mode]
    got = [ab._head_outputs(study['state'], ab.MODES[mode], b) for b in study['val']]
    for k in HEADS:
        a = torch.cat([g[k] for g in got]).double().numpy()
        b = want[k].astype(np.float64)
        assert a.shape == b.shape and np.abs(b).max() > 0, k
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), (k, mode)
    scores = ab.evaluate_state(study['state'], ab.MODES[mode], study['val'])
    want_scores = _jax_scores(want, seg_label, instance)
    assert want_scores['iou'] > 0, want_scores
    for k in ('iou', 'vpq'):
        assert abs(scores[k] - want_scores[k]) <= 1e-3, (k, scores, want_scores)


def test_depth_stats_match_jax(study):
    entropy, mass = ab._depth_stats(study['state'], study['act'], k=8)
    depth = study['depth'].astype(np.float64)
    want_entropy = -(depth * np.log(np.clip(depth, 1e-12, None))).sum(-1).ravel()
    want_mass = np.sort(depth, axis=-1)[..., -8:].sum(-1).ravel()
    assert entropy.shape == want_entropy.shape == (2 * 2 * 4 * 4 * 6,)
    np.testing.assert_allclose(entropy, want_entropy, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mass, want_mass, rtol=0, atol=1e-5)
    # a spread depth head: neither uniform nor one-hot
    assert 0.1 < float(np.median(want_entropy)) < np.log(24) - 0.1
    assert 8 / 24 + 0.05 < float(np.median(want_mass)) < 1


@pytest.mark.parametrize('mode', ['dense', 'topk8', 'warpfree'])
def test_bev_features_match_jax(study, mode):
    got = ab._bev_features(study['state'], ab.MODES[mode], study['act']).numpy()
    want = study['bev'][mode]
    scale = float(np.abs(study['bev']['dense']).max())
    assert got.shape == want.shape == (2, 2, 64, 64, 24) and scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale, err_msg=mode)
    if mode != 'dense':           # a lever changes the features
        assert np.abs(want - study['bev']['dense']).max() > 1e-3 * scale


# ---- the study's JSON and report ----

def _key_tree(x):
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_key_tree(x[0])] if x and isinstance(x[0], (dict, list)) else []
    return None


def test_a_cpu_train_study_writes_the_harness_json_and_table(tmp_path, monkeypatch, capsys):
    """Two steps of every mode for one seed on 4 training clips, through ``main``, at
    a narrower BASE (2 cameras, a 32 x 32 grid, batch 2: the JSON's keys do not
    depend on the widths) and 2 validation clips. The JSON's keys and nesting are
    JAX's r5 file's plus ``device``, with base_cfg holding BASE (JAX's _merge set
    TRIM_TRAIN in BASE's nested dict before r5 wrote it); the dense state is cached
    for the activation study."""
    for name in ('N_TRAIN', '_TRAINERS', '_EVAL_TRAINERS'):
        monkeypatch.setattr(ab, name, type(getattr(ab, name))(getattr(ab, name)))
    narrow = ab._merge(ab.BASE, {'BATCHSIZE': 2, 'IMAGE': {'NAMES': ['CAM_A', 'CAM_B']},
                                 'LIFT': {'X_BOUND': [-6.0, 6.0, 0.375],
                                          'Y_BOUND': [-6.0, 6.0, 0.375]}})
    monkeypatch.setattr(ab, 'BASE', narrow)
    monkeypatch.setattr(ab, 'N_VAL', 2)
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    out = tmp_path / 'train.json'
    ab.main(['train', '--steps', '2', '--seeds', '1', '--n-train', '4', '--device', 'cpu',
             '--out', str(out)])
    got = json.loads(out.read_text())
    with open(os.path.join(REPO, 'reports', 'accuracy_ab_train_r5.json')) as f:
        r5 = json.load(f)
    want = dict(_key_tree(r5), device=None, base_cfg=_key_tree(json.loads(json.dumps(ab.BASE))))
    assert _key_tree(got) == want
    assert got['device'] == 'cpu' and got['n_train'] == 4 and got['seeds'] == [0]
    assert got['n_val'] == 2
    assert got['base_cfg'] == json.loads(json.dumps(ab.BASE))
    for mode in ab.MODES:
        row = got['results'][mode]['per_seed'][0]
        assert np.isfinite(row['final_loss_mean_last50'])
        assert all(0 <= v <= 1 for e in ('eval_matched', 'eval_dense_parity')
                   for v in row[e].values())
    assert os.path.exists(ab._dense_cache_path(2))
    capsys.readouterr()

    spec = importlib.util.spec_from_file_location('jax_accuracy_report',
                                                  os.path.join(REPO, 'tools',
                                                               'accuracy_report.py'))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    texts = []
    for module in (harness, accuracy_report):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            module.main(str(out))
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and '| dense |' in texts[0]


def test_the_report_imports_only_json_and_sys():
    with open(accuracy_report.__file__) as f:
        tree = ast.parse(f.read())
    imported = {alias.name for node in ast.walk(tree)
                if isinstance(node, (ast.Import, ast.ImportFrom))
                for alias in getattr(node, 'names', [])}
    assert imported == {'json', 'sys'}


def test_the_report_skips_the_device_of_an_activation_json(tmp_path, capsys):
    """The port's activation JSON holds ``device`` beside the two states' rows; the
    report prints the rows as the harness prints JAX's JSON."""
    act = os.path.join(REPO, 'reports', 'accuracy_ab_activation.json')
    train = os.path.join(REPO, 'reports', 'accuracy_ab_train_r5.json')
    with open(act) as f:
        rows = json.load(f)
    ours = tmp_path / 'act.json'
    ours.write_text(json.dumps({**rows, 'device': 'cpu'}))
    accuracy_report.main(train, act)
    want = capsys.readouterr().out
    accuracy_report.main(train, str(ours))
    assert capsys.readouterr().out == want and '| trained |' in want


def test_the_report_holds_a_study_against_the_reference(tmp_path, capsys):
    """``--against``: each mode's mean minus the reference's, in units of the root of
    the two seed variances."""
    train = os.path.join(REPO, 'reports', 'accuracy_ab_train_r5.json')
    with open(train) as f:
        ours = json.load(f)
    dense = ours['results']['dense']['iou_matched']
    dense['mean'] += 2 * (2 * dense['sd'] ** 2) ** 0.5
    ours['results']['topk8']['vpq_matched']['sd'] = 0.0
    path = tmp_path / 'ours.json'
    path.write_text(json.dumps(ours))
    accuracy_report.compare(str(path), train)
    rows = {line.split(' | ')[0].strip('| '): line.split(' | ')
            for line in capsys.readouterr().out.splitlines()[2:]}
    assert sorted(rows) == sorted(ab.MODES)
    assert rows['dense'][3] == '+2.00' and rows['dense'][6].startswith('+0.00')
    assert rows['warpfree'][3] == '+0.00'
    assert rows['topk8'][6].startswith('+0.00')     # the reference's sd alone
