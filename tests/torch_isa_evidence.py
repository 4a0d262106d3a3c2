"""Why the JAX references of the port's step tests run with XLA's CPU code capped
at one instruction set (tests/torch_jax_reference.py): the distances among the
port, JAX under ``--xla_cpu_max_isa=AVX2``, JAX under ``--xla_cpu_max_isa=AVX512``
and an f64 reference, on the quantities that tests/test_torch_trainer.py,
tests/test_torch_parallel_step.py and tests/test_torch_camera_parallel_step.py
hold. Prints one JSON object. On the CPU, ~5 min:

    JAX_PLATFORMS=cpu python tests/torch_isa_evidence.py OUT_DIR

1. ``running_var``: the new running variance of the future distribution's first
   down-projection BatchNorm after the tiny one-process step
   (``test_train_step_batch_statistics_match_jax``), the largest relative distance
   over its channels. f64: the batch variance of that BatchNorm's input recomputed
   in f64 from the f32 input of the convolution before it, with the port's weights.
2. ``bn_reduction``: the batch variance of that BatchNorm's f32 input (the port's),
   computed by the JAX package's formula alone (``fiery_tpu/models/layers.py``
   ``_BNCore``: f32 means of x and x^2, then their difference) in a jitted function
   under each cap, against the f64 variance of the same input: where the two caps
   part.
3. ``decoder``: the relative L2 distance of the decoder's Adam first moments after
   the 2-device step (``test_two_ranks_take_the_jax_two_device_step``): the port's
   two gloo ranks against JAX's ``make_parallel_train_step`` under each cap (no f64
   step of the whole model is computed).
"""

import json
import os
import pathlib
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

NAME = 'future_distribution.encoder.model.0.layers.abn_down_project.0'
# where main and its reference processes leave and find the BatchNorm's input
OUT = os.environ.get('FIERY_ISA_EVIDENCE_DIR', '.')


def trainer_statistic():
    """The port's and JAX's new running variance of NAME, and its f64 value."""
    import torch

    import test_torch_trainer as T
    captured = {}
    init = T.Trainer.__init__

    def hooked(self, *a, **k):
        init(self, *a, **k)

        def bn_hook(m, args):
            captured.setdefault('rv0', m.running_var.detach().clone())
            captured.setdefault('x', args[0].detach().clone())

        def conv_hook(m, args):
            captured.setdefault('cin', args[0].detach().clone())
            captured.setdefault('w', m.weight.detach().clone())
        self.model.get_submodule(NAME).register_forward_pre_hook(bn_hook)
        self.model.get_submodule(NAME.replace('abn_down_project.0', 'conv_down_project')) \
            .register_forward_pre_hook(conv_hook)
    T.Trainer.__init__ = hooked
    try:
        mp = T.drop_connect_off()
        try:
            trainer, batch, noise = T.seeded_step_inputs()
            trainer.compute_gradients(batch, noise=torch.from_numpy(noise))
        finally:
            mp.undo()
    finally:
        T.Trainer.__init__ = init
    torch.save(captured['x'], os.path.join(OUT, 'bn_input.pt'))
    x64 = torch.nn.functional.conv2d(captured['cin'].double(), captured['w'].double())
    var64 = x64.var(dim=(0, 2, 3), unbiased=False)
    f64 = 0.9 * captured['rv0'].double() + 0.1 * var64
    return {'port': trainer.model.state_dict()[NAME + '.running_var'].double().numpy(),
            'f64': f64.numpy()}


def jax_statistic():
    """JAX's new running variance of NAME (run in a reference process)."""
    import test_torch_trainer as T
    from fiery_tpu_torch.models.fiery import FieryConfig
    from fiery_tpu_torch.utils.config import get_cfg
    from fiery_tpu_torch.utils.weight_import import train_state_from_jax
    want = T.jax_train_step()
    new, _ = train_state_from_jax(want['params'], want['new_stats'],
                                  FieryConfig.from_cfg(get_cfg(cfg_dict=T.TINY)))
    return new[NAME + '.running_var'].double().numpy()


def jax_bn_variance():
    """The JAX BatchNorm's batch variance of the saved input (a reference process)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    x = jnp.asarray(torch.load(os.path.join(OUT, 'bn_input.pt')).permute(0, 2, 3, 1).numpy())

    @jax.jit
    def variance(x):
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axes)
        return jnp.maximum(jnp.mean(jnp.square(x), axes) - jnp.square(mean), 0.0)
    return np.asarray(variance(x)).astype(np.float64)


def main(out_dir):
    import numpy as np
    import torch

    from torch_jax_reference import jax_reference
    from torch_parallel_worker import TINY_JAX, seeded_trainer, spawn_ranks, tiny_cfg
    global OUT
    os.makedirs(out_dir, exist_ok=True)
    OUT = os.environ['FIERY_ISA_EVIDENCE_DIR'] = os.path.abspath(out_dir)
    result = {}
    port = trainer_statistic()
    values = {'port': port['port'], 'f64': port['f64']}
    for isa in ('AVX2', 'AVX512'):
        values[f'jax_{isa}'] = jax_reference('torch_isa_evidence:jax_statistic', out_dir, isa)

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))
    keys = sorted(values)
    result['running_var'] = {f'{a} vs {b}': rel(values[a], values[b])
                             for i, a in enumerate(keys) for b in keys[i + 1:]}

    x = torch.load(os.path.join(out_dir, 'bn_input.pt')).double()
    var64 = x.var(dim=(0, 2, 3), unbiased=False).numpy()
    result['bn_reduction'] = {
        f'jax_{isa} vs f64': rel(jax_reference('torch_isa_evidence:jax_bn_variance', out_dir,
                                               isa), var64)
        for isa in ('AVX2', 'AVX512')}

    ranks = spawn_ranks('steps', pathlib.Path(out_dir), 2)
    trainer = seeded_trainer(tiny_cfg(TINY_JAX))
    names = [n for n, _ in trainer.model.named_parameters()] + \
        ['uncertainty.' + k for k in trainer.uncertainty]
    dec = [i for i, n in enumerate(names) if n.startswith('decoder.')]
    moments = {'port': torch.cat([ranks[0]['noise']['exp_avg'][i].double().flatten()
                                  for i in dec])}
    for isa in ('AVX2', 'AVX512'):
        _, state = jax_reference('test_torch_parallel_step:jax_two_device_step', out_dir, isa)
        moments[f'jax_{isa}'] = torch.cat([torch.as_tensor(
            state['optimizer']['state'][i]['exp_avg']).double().flatten() for i in dec])
    keys = sorted(moments)
    result['decoder'] = {f'{a} vs {b}': float((moments[a] - moments[b]).norm()
                                              / moments[b].norm())
                         for i, a in enumerate(keys) for b in keys[i + 1:]}
    print(json.dumps(result, indent=1))


if __name__ == '__main__':
    main(sys.argv[1])
