"""The training step (counterpart of fiery_tpu/training/trainer.py).

A step prepares the labels (the future label maps warped back to the present frame
by the nearest warp, kernel K4), runs the model's training forward (the future
distribution sampled with fresh noise, drop-connect), computes the losses (the
top-k segmentation mean through kernel K3), back-propagates (through the backward
kernels of the splat K1 and the warp K2), clips the global gradient norm and takes
an Adam step with coupled L2 weight decay, in the order of the JAX package's optax
chain: clip, add the decayed weights, Adam.

Under DATASET.PREWARP_LABELS the batch carries the label stack already warped on
the host (data/label_warp.py ``PrewarpTransform``), and K4 does not run.

The model keeps float32 parameters; under PRECISION 16 it computes in bfloat16
(the convolutions cast their weights on the fly), as the JAX package's modules do
with ``dtype=bfloat16``. The learned uncertainty weights of the losses are
parameters too and take part in the clip and in Adam.

    trainer = Trainer(cfg)                              # on cuda; depth_keep= for DEPTH_CULL
    init_params(trainer.model, seed=0)
    generator = torch.Generator(device=trainer.device).manual_seed(0)
    losses, total = trainer.train_step(batch, generator)

The generator lives on the trainer's device, so that drawing the drop-connect
masks and the latent noise never waits on the host; the training loop seeds one a
step (``step_generator``).

Data-parallel (parallel/mesh.py ``make_parallel_trainer``): each rank's trainer
takes its share of the global batch; ``forward_losses`` is then the losses module
inside DistributedDataParallel, the BatchNorms take their statistics over the
ranks, a ``noise`` given is the global batch's (each rank keeps its rows), the
generator is ``step_generator(..., rank, world)``'s, and the returned losses are
the global ones. ``Trainer.state()`` and ``Trainer.load_state()`` are what
a checkpoint holds (``utils/checkpoint.py``): the weights, the uncertainty weights,
the Adam state and the step.
"""

import dataclasses

import torch
import torch.nn as nn

from fiery_tpu_torch.models.fiery import Fiery, FieryConfig
from fiery_tpu_torch.ops.warp import cumulative_warp_features_reverse
from fiery_tpu_torch.parallel.mesh import RankGenerator, global_losses, rank_rows
from fiery_tpu_torch.training.losses import compute_losses, init_uncertainty_weights
from fiery_tpu_torch.utils.device import device_constant, resolve_device

INPUTS = ('image', 'intrinsics', 'extrinsics', 'future_egomotion')


def clip_by_global_norm_(grads, max_norm):
    """Scale the gradients in place as optax.clip_by_global_norm does; returns the
    global norm, a 0-d tensor on their device.

    The norm is the square root of the summed squares of every gradient (one
    reduction over their concatenation, cheaper on the host than a list of
    per-tensor squares), summed in f64 and rounded once to f32: an f32 sum's error
    depends on its order, which the host's BLAS picks (an AVX-512 host's f32 dot
    missed the f64 norm by 5e-5 relative, and moved a clipped step's Adam moments
    past JAX's by as much). Each gradient t stays as it is when the norm is
    below max_norm, else it becomes (t / norm) * max_norm: a division, then a
    multiplication. Both factors are chosen on the device (1 and 1 below the clip),
    so the step never waits on the host and an unclipped gradient keeps its bits."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    norm = torch.linalg.vector_norm(flat, dtype=torch.float64).float()
    del flat
    one, clip = device_constant((1.0, max_norm), torch.float32, norm.device)
    keep = norm < clip
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, clip))
    return norm


def step_generator(seed, step, device, rank=0, world=1):
    """The random stream of one training step: a generator on ``device`` seeded
    from (seed, step), as the JAX package folds the step into its key. A resumed
    run draws what an uninterrupted one draws, with no generator state saved. On
    rank ``rank`` of ``world`` (> 1) a ``RankGenerator`` of the same seed: the
    ranks' draws together are one process's on the global batch."""
    g = (torch.Generator(device=device) if world == 1
         else RankGenerator(torch.device(device), rank, world))
    return g.manual_seed((int(seed) << 32) + int(step))


class StepLosses(nn.Module):
    """The model and the uncertainty weights as one module whose forward is a
    training step's loss dict: what DistributedDataParallel wraps, so that every
    gradient, the uncertainty weights' too, is averaged over the ranks. ``group``:
    the process group of the masked losses' global count, or None."""

    def __init__(self, model, uncertainty, cfg):
        super().__init__()
        self.model, self.uncertainty, self.cfg = model, uncertainty, cfg
        self.group = None

    def forward(self, inputs, future_distribution_inputs, labels, noise=None,
                generator=None):
        output = self.model(*inputs, future_distribution_inputs, noise=noise,
                            generator=generator)
        return compute_losses(output, labels, self.uncertainty, self.cfg, group=self.group)


class Trainer:
    """Owns the model, the uncertainty weights and the optimizer."""

    def __init__(self, cfg, depth_keep=None, device=None):
        """depth_keep: the per-camera kept depth-plane counts of LIFT.DEPTH_CULL
        (``ops.lift_splat.compute_depth_plane_keep``), or None."""
        device = resolve_device(device)
        self.cfg = cfg
        self.device = device
        model_cfg = FieryConfig.from_cfg(cfg)
        if depth_keep is not None:
            model_cfg = dataclasses.replace(
                model_cfg, depth_keep=tuple(int(k) for k in depth_keep))
        self.model = Fiery(model_cfg).to(device).train()
        self.uncertainty = init_uncertainty_weights(cfg.INSTANCE_FLOW.ENABLED).to(device)
        self.params = list(self.model.parameters()) + list(self.uncertainty.parameters())
        # torch.optim.Adam's weight decay is coupled L2 (wd * param added to the
        # clipped gradient before the moments), the JAX package's
        # add_decayed_weights + scale_by_adam; one fused launch on the card
        self.optimizer = torch.optim.Adam(self.params, lr=cfg.OPTIMIZER.LR,
                                          weight_decay=cfg.OPTIMIZER.WEIGHT_DECAY,
                                          fused=device.type == 'cuda')
        self.step = 0              # optimizer steps taken, the JAX TrainState's step
        # the losses of a step's forward; make_parallel_trainer wraps it in DDP
        self.step_losses = StepLosses(self.model, self.uncertainty, cfg)
        self.forward_losses = self.step_losses
        self.group, self.rank, self.world = None, 0, 1

    def state(self):
        """What a checkpoint holds: the model's state_dict, the uncertainty weights,
        the Adam state and the step (tensors on the trainer's device)."""
        return {'model': self.model.state_dict(),
                'uncertainty': {k: p.detach() for k, p in self.uncertainty.items()},
                'optimizer': self.optimizer.state_dict(), 'step': self.step}

    def load_state(self, state, strict=True):
        """Load a ``state()`` (from any device). Under strict, every model entry
        and uncertainty weight must be there with its shape, and nothing else; a
        state without Adam state (``'optimizer'`` None, as a weight import gives)
        leaves the optimizer as it is. The optimizer keeps its own hyperparameters
        (the config's) and takes the per-parameter state."""
        self.model.load_state_dict(state['model'], strict=strict)
        uncertainty = state['uncertainty']
        if strict and sorted(uncertainty) != sorted(self.uncertainty):
            raise KeyError(f'uncertainty weights {sorted(uncertainty)} do not match the '
                           f'model\'s {sorted(self.uncertainty)}')
        with torch.no_grad():
            for k, p in self.uncertainty.items():
                if k in uncertainty:
                    p.copy_(torch.as_tensor(uncertainty[k]).reshape(p.shape))
        if state.get('optimizer') is not None:
            saved = state['optimizer']['state']
            if strict:
                for i, p in enumerate(self.params):
                    if i in saved and saved[i]['exp_avg'].shape != p.shape:
                        raise ValueError(f'Adam state {i}: shape {tuple(saved[i]["exp_avg"].shape)} '
                                         f'!= parameter {tuple(p.shape)}')
                if set(saved) - set(range(len(self.params))):
                    raise KeyError(f'Adam state for {len(saved)} parameters, the model has '
                                   f'{len(self.params)}')
            own = self.optimizer.state_dict()
            own['state'] = saved
            self.optimizer.load_state_dict(own)
        self.step = int(state['step'])

    def to_device(self, batch):
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def prepare_future_labels(self, batch):
        """The present and future label maps warped back to the present frame, and
        the future distribution's conditioning input.

        batch (tensors on the device, channels-last): segmentation (b, s, h, w, 1),
        instance (b, s, h, w), centerness (b, s, h, w, 1), offset and flow
        (b, s, h, w, 2), future_egomotion (b, s, 6); or a precomputed
        warped_label_stack (b, 1 + n_future, h, w, 7). All label maps share the
        warp's grid, so they are warped as one 7-channel stack.
        """
        rf = self.model.cfg.receptive_field
        if 'warped_label_stack' in batch:
            stacked = batch['warped_label_stack'].float()
        else:
            maps = [batch['segmentation'][:, rf - 1:].float(),
                    batch['instance'][:, rf - 1:].float()[..., None],
                    batch['centerness'][:, rf - 1:].float(),
                    batch['offset'][:, rf - 1:].float()]
            if self.cfg.INSTANCE_FLOW.ENABLED:
                maps.append(batch['flow'][:, rf - 1:].float())
            stacked = cumulative_warp_features_reverse(
                torch.cat(maps, dim=-1), batch['future_egomotion'][:, rf - 1:].float(),
                mode='nearest', spatial_extent=self.model.cfg.spatial_extent)
        labels = {'segmentation': torch.round(stacked[..., 0]).long(),
                  'instance': torch.round(stacked[..., 1]).long(),
                  'centerness': stacked[..., 2:3],
                  'offset': stacked[..., 3:5]}
        if self.cfg.INSTANCE_FLOW.ENABLED:
            labels['flow'] = stacked[..., 5:7]
        # every warped map but the raw instance ids
        future_distribution_inputs = torch.cat([stacked[..., 0:1], stacked[..., 2:]], dim=-1)
        return labels, future_distribution_inputs

    def compute_gradients(self, batch, generator=None, noise=None):
        """Forward, losses and backward of one step, leaving the gradients in the
        parameters' ``.grad`` (averaged over the ranks when data-parallel). Returns
        (loss dict, total loss), detached: the global batch's."""
        if generator is not None and generator.device.type != self.device.type:
            raise ValueError(f'the generator is on {generator.device} and the trainer on '
                             f'{self.device}: each draw would be a blocking copy')
        if (self.world > 1 and generator is not None
                and getattr(generator, 'world', 1) != self.world):
            raise ValueError('a data-parallel step draws from step_generator(..., rank, world)')
        batch = self.to_device(batch)
        if noise is not None and self.world > 1:
            noise = rank_rows(noise, batch['image'].shape[0], self.rank)
        self.model.train()
        labels, fdi = self.prepare_future_labels(batch)
        losses = self.forward_losses([batch[k] for k in INPUTS], fdi, labels, noise, generator)
        total = sum(losses.values())
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        losses, total = {k: v.detach() for k, v in losses.items()}, total.detach()
        if self.group is not None:
            losses, total = global_losses(losses, total, self.group)
        return losses, total

    def apply_gradients(self):
        """Clip the global gradient norm (``clip_by_global_norm_``), then the Adam
        step."""
        clip_by_global_norm_([p.grad for p in self.params if p.grad is not None],
                             self.cfg.GRAD_NORM_CLIP)
        self.optimizer.step()
        self.step += 1

    def train_step(self, batch, generator=None, noise=None):
        """One optimisation step on a batch (numpy arrays or tensors). The generator,
        on the trainer's device, draws the latent noise (unless ``noise`` (b, 1, L)
        is given) and the drop-connect masks. Returns (loss dict, total loss),
        detached tensors."""
        losses, total = self.compute_gradients(batch, generator, noise)
        self.apply_gradients()
        return losses, total

    @torch.no_grad()
    def eval_step(self, batch, noise=None):
        """The eval forward (running statistics, the present distribution, zero
        noise unless given) and the losses: (output, labels, loss dict)."""
        batch = self.to_device(batch)
        self.model.eval()
        try:
            labels, fdi = self.prepare_future_labels(batch)
            output = self.model(*(batch[k] for k in INPUTS), fdi, noise=noise)
            return output, labels, compute_losses(output, labels, self.uncertainty,
                                                  self.cfg)
        finally:
            self.model.train()
