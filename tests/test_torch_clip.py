"""The gradient clip of the port's training step against optax.clip_by_global_norm,
the first link of the JAX package's optimizer chain (CPU, f32): an active clip
(clip 1e-3, global norm near 2e-3) equal to optax within one f32 ulp a value, an
inactive one leaving every gradient's bits as they were; and on the card one
``Trainer.apply_gradients`` with no host synchronisation (marked ``gpu``, skips
without a card).

optax and JAX are imported inside the CPU tests, so that the card's case runs
where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_clip.py -m gpu
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.training.trainer import clip_by_global_norm_

SHAPES = ((64, 3, 3, 3), (64,), (128, 64), (7,), (32, 16, 3, 3), (1,))


def _gradients(seed, norm, dyadic):
    """Seeded gradients of SHAPES scaled to about ``norm``. dyadic: small integers
    times a power of two, whose squares and their sums are exact in f32 in any
    order, so that both sides compute the same norm and the clip's own arithmetic is
    what the comparison sees."""
    rng = np.random.RandomState(seed)
    if dyadic:
        grads = [rng.randint(-15, 16, s).astype(np.float32) for s in SHAPES]
        total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
        scale = 2.0 ** np.round(np.log2(norm / total))
        return [(g * scale).astype(np.float32) for g in grads]
    grads = [rng.randn(*s) for s in SHAPES]
    total = np.sqrt(sum(float((g ** 2).sum()) for g in grads))
    return [(g * (norm / total)).astype(np.float32) for g in grads]


def _optax(grads, clip):
    import jax
    import jax.numpy as jnp
    optax = pytest.importorskip('optax')
    jax.config.update('jax_platforms', 'cpu')
    tx = optax.clip_by_global_norm(clip)
    out, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    return [np.asarray(o) for o in out], float(optax.global_norm(
        [jnp.asarray(g) for g in grads]))


def _ulps(a, b):
    """Largest distance in f32 ulps between two arrays of one sign pattern."""
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_active_clip_equals_optax_within_one_ulp(seed):
    grads = _gradients(seed, 2e-3, dyadic=True)
    want, want_norm = _optax(grads, 1e-3)
    assert want_norm > 1e-3                           # the clip is active
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(got, 1e-3)
    assert float(norm) == want_norm
    for g, w in zip(got, want):
        assert _ulps(g.numpy(), w) <= 1


@pytest.mark.parametrize('seed', [3, 4])
def test_active_clip_on_generic_gradients_is_optax_rule(seed):
    """Generic f32 gradients: the two norms differ only by the order of their f32
    sums (a few ulps), so the clipped values agree to 1e-6 relative; a scale of
    clip / (norm + 1e-6) would miss by 5e-4."""
    grads = _gradients(seed, 2e-3, dyadic=False)
    want, _ = _optax(grads, 1e-3)
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, 1e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)


@pytest.mark.parametrize('dyadic', [True, False])
def test_inactive_clip_leaves_the_bits(dyadic):
    grads = _gradients(5, 2e-3, dyadic=dyadic)
    want, want_norm = _optax(grads, 5.0)
    assert want_norm < 5.0
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, 5.0)
    for g, w, before in zip(got, want, grads):
        assert _ulps(g.numpy(), before) == 0 and _ulps(w, before) == 0


@pytest.mark.gpu
def test_apply_gradients_on_the_card_waits_on_no_host():
    """One apply_gradients (the clip active, then fused Adam) on the card under
    set_sync_debug_mode('error'), after a warm-up call that makes Adam's state; the
    weights move."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from fiery_tpu_torch.serve import init_params
    from fiery_tpu_torch.training.trainer import Trainer
    from fiery_tpu_torch.utils.config import get_cfg
    cfg = get_cfg(cfg_dict={
        'PRECISION': 32, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 2,
        'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_A', 'CAM_B']},
        'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
                 'D_BOUND': [2.0, 8.0, 1.0]},
        'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
                  'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
                  'DISTRIBUTION': {'LATENT_DIM': 4},
                  'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 2}}})
    trainer = Trainer(cfg)
    init_params(trainer.model, seed=0)
    gen = torch.Generator(device='cuda').manual_seed(0)

    def fill():
        for p in trainer.params:
            p.grad = torch.randn(p.shape, generator=gen, device='cuda')

    fill()
    trainer.apply_gradients()
    fill()
    before = [p.detach().clone() for p in trainer.params]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        trainer.apply_gradients()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert all(not torch.equal(p.detach(), b) for p, b in zip(trainer.params, before))
