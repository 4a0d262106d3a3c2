"""On the card: the served form (``serve.build_served``: BatchNorm folded, both
requests captured as CUDA graphs) at a tiny config against the eager folded model,
every output and id bit for bit on requests other than the one captured, with no
Python launch during a replay; and the same of the exported program
(``export.export_model`` on the card, ``load_exported``), which refuses to load on
the CPU. Every test needs a CUDA device and skips without one.

The file imports nothing of JAX, so that it runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_served_gpu.py
"""

import pytest
import torch

from fiery_tpu_torch.export import export_model, load_exported, read_artifact
from fiery_tpu_torch.ops.batch_norm import batch_norm_forward
from fiery_tpu_torch.ops.lift_splat import bev_pool
from fiery_tpu_torch.postprocess.instance import instance_ids
from fiery_tpu_torch.serve import (build_fiery, build_served, make_request, predict,
                                   predict_instances, seeded_state_dict)
from fiery_tpu_torch.serve_graph import ServedFiery
from fiery_tpu_torch.utils.config import get_cfg

pytestmark = pytest.mark.gpu

# the tiny config of tests/test_torch_trainer.py, served in bf16
TINY = {
    'PRECISION': 16, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 2,
    'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_A', 'CAM_B']},
    'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
             'D_BOUND': [2.0, 8.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 4},
              'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 2}},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('levers', [{}, {'TOPK': 3, 'WARP_FREE': True}],
                         ids=['dense', 'combo'])
def test_replay_equals_the_eager_folded_model(cuda, levers):
    cfg = get_cfg(cfg_dict={**TINY, 'LIFT': {**TINY['LIFT'], **levers}})
    state_dict = seeded_state_dict(cfg, seed=0)
    served = build_served(cfg, state_dict)
    eager = build_fiery(cfg, state_dict=state_dict, fold_bn=True)

    def counts():
        return bev_pool.launches, batch_norm_forward.launches, instance_ids.launches

    for seed in (10, 11, 12):
        request = make_request(cfg, seed)
        before = counts()
        got, got_ids = served.predict_instances(request)
        got_bare = served.predict({k: torch.from_numpy(v).to(cuda)
                                   for k, v in request.items()})
        assert counts() == before        # a replay calls no wrapper
        want, want_ids = predict_instances(eager, request)
        assert torch.equal(got_ids, want_ids)
        assert sorted(got) == sorted(want) == sorted(got_bare)
        for k, v in want.items():
            assert torch.isfinite(v).all() and torch.equal(got[k], v), k
            assert torch.equal(got_bare[k], v), k
    # the outputs are the caller's: a later replay leaves them as they were
    kept = {k: v.clone() for k, v in got.items()}
    served.predict(make_request(cfg, 13))
    assert all(torch.equal(kept[k], got[k]) for k in kept)
    assert not torch.equal(predict(eager, make_request(cfg, 13))['segmentation'],
                           got['segmentation'])


@pytest.mark.parametrize('levers', [{}, {'TOPK': 3, 'WARP_FREE': True}],
                         ids=['dense', 'combo'])
def test_the_exported_program_replays_the_eager_folded_model(cuda, levers, tmp_path):
    cfg = get_cfg(cfg_dict={**TINY, 'LIFT': {**TINY['LIFT'], **levers}})
    state_dict = seeded_state_dict(cfg, seed=0)
    path = tmp_path / 'model.fiery'
    path.write_bytes(export_model(cfg, state_dict=state_dict)[0])
    assert read_artifact(str(path))['device'] == torch.device('cuda',
                                                              torch.cuda.current_device())
    with pytest.raises(ValueError, match='does not run on cpu'):
        load_exported(str(path), device='cpu')
    served = load_exported(str(path))
    assert isinstance(served, ServedFiery) and isinstance(served.model, torch.fx.GraphModule)
    eager = build_fiery(cfg, state_dict=state_dict, fold_bn=True)
    counts = (bev_pool.launches, batch_norm_forward.launches, instance_ids.launches)
    with torch.inference_mode():
        served.model(*(served.static[k] for k in ('image', 'intrinsics', 'extrinsics',
                                                  'future_egomotion')))
    assert bev_pool.launches > counts[0] and batch_norm_forward.launches > counts[1]
    for seed in (10, 11):
        request = make_request(cfg, seed)
        before = (bev_pool.launches, batch_norm_forward.launches, instance_ids.launches)
        got, got_ids = served.predict_instances(request)
        got_bare = served.predict(request)
        assert (bev_pool.launches, batch_norm_forward.launches,
                instance_ids.launches) == before       # a replay calls no wrapper
        want, want_ids = predict_instances(eager, request)
        assert torch.equal(got_ids, want_ids)
        assert sorted(got) == sorted(want) == sorted(got_bare)
        for k, v in want.items():
            assert torch.isfinite(v).all() and torch.equal(got[k], v), k
            assert torch.equal(got_bare[k], v), k
