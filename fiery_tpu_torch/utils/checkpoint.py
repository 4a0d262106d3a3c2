"""Checkpoint save, load and resume (counterpart of fiery_tpu/utils/checkpoint.py).

A checkpoint is a directory:

    <dir>/state/state.pt   one torch.save file: {'model': the Fiery state_dict,
                           'uncertainty': {name: 0-d tensor}, 'optimizer': the Adam
                           state_dict, 'step': int}, CPU tensors
    <dir>/config.json      the config, written last: its presence commits the
                           checkpoint (a save cut short leaves none, and the
                           directory is skipped by ``find_latest_checkpoint``)

``Trainer.state()`` gives the state and ``Trainer.load_state(state, strict=True)``
takes it back, so evaluation rebuilds the model from the checkpoint alone. The
JAX package's orbax directories are not read here; a JAX train state converts
through ``utils/weight_import.checkpoint_state_from_jax``. A reference
(Lightning) ``.ckpt`` loads through ``load_torch_full_checkpoint``.
"""

import io
import json
import os
import threading

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from fiery_tpu_torch.models.fiery import Fiery, FieryConfig
from fiery_tpu_torch.training.losses import init_uncertainty_weights
from fiery_tpu_torch.utils.config import get_cfg

_STATE_DIR = 'state'
_STATE_FILE = 'state.pt'
_CFG_FILE = 'config.json'
UNCERTAINTY_KEYS = frozenset(init_uncertainty_weights(instance_flow_enabled=True))
_async_thread = [None]


def host_copy(obj):
    """A copy of a nested state in host memory. The tensors of one device and dtype
    are concatenated there and copied to the host in one transfer (a state holds
    ~3,000 tensors: one copy each costs a synchronisation each), then split into
    views of that host buffer, one per tensor."""
    leaves, spec = tree_flatten(obj)
    groups = {}
    for i, t in enumerate(leaves):
        if isinstance(t, torch.Tensor):
            groups.setdefault((t.device, t.dtype), []).append(i)
    copies = list(leaves)
    for members in groups.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in members]).to('cpu')
        for i, part in zip(members, flat.split([leaves[i].numel() for i in members])):
            copies[i] = part.view(leaves[i].shape)
    return tree_unflatten(copies, spec)


def serialise(state_host):
    """The bytes of ``torch.save`` of a host state."""
    buf = io.BytesIO()
    torch.save(state_host, buf)
    return buf.getvalue()


def _write(path, state_bytes, cfg_dict):
    path = os.path.abspath(path)
    marker = os.path.join(path, _CFG_FILE)
    if os.path.exists(marker):
        os.remove(marker)                  # uncommitted until the new state is written
    os.makedirs(os.path.join(path, _STATE_DIR), exist_ok=True)
    state_file = os.path.join(path, _STATE_DIR, _STATE_FILE)
    with open(state_file + '.tmp', 'wb') as f:
        f.write(state_bytes)
    os.replace(state_file + '.tmp', state_file)
    with open(marker + '.tmp', 'w') as f:
        json.dump(cfg_dict, f, indent=2)
    os.replace(marker + '.tmp', marker)


def save_checkpoint(path, trainer, cfg):
    """Write ``trainer``'s state and ``cfg`` to the checkpoint directory ``path``."""
    wait_for_async_save()
    _write(path, serialise(host_copy(trainer.state())), cfg.convert_to_dict())


def save_checkpoint_async(path, trainer, cfg):
    """Copy the state to the host and serialise it now, and write the bytes on a
    background thread, one write in flight at a time (a second save waits for the
    first), so that the loop goes on with its steps meanwhile. The thread only
    writes a file, which releases the interpreter lock; pickling there would hold
    it against the steps' Python. ``wait_for_async_save`` joins it; a write that
    failed raises there."""
    state_bytes = serialise(host_copy(trainer.state()))
    cfg_dict = cfg.convert_to_dict()
    wait_for_async_save()

    def write():
        try:
            _write(path, state_bytes, cfg_dict)
        except Exception as e:           # raised again by wait_for_async_save
            thread.error = e

    thread = threading.Thread(target=write, daemon=True)
    thread.error = None
    _async_thread[0] = thread
    thread.start()


def wait_for_async_save():
    thread = _async_thread[0]
    if thread is not None:
        thread.join()
        _async_thread[0] = None
        if thread.error is not None:
            raise RuntimeError('the background checkpoint write failed') from thread.error


def _is_checkpoint_dir(path):
    """Complete iff the state file and the config marker (written last) exist."""
    return (os.path.isfile(os.path.join(path, _STATE_DIR, _STATE_FILE))
            and os.path.isfile(os.path.join(path, _CFG_FILE)))


def find_latest_checkpoint(path):
    """Resolve ``path`` to a complete checkpoint directory, or None.

    Accepts a checkpoint directory itself; a run directory holding
    ``checkpoint_epochN`` / ``checkpoint_final`` (``checkpoint_final`` if complete,
    else the highest complete epoch); or a log directory of runs (the most recently
    modified run that holds a complete checkpoint)."""
    path = os.path.abspath(path)
    if _is_checkpoint_dir(path):
        return path
    if not os.path.isdir(path):
        return None
    final = os.path.join(path, 'checkpoint_final')
    if _is_checkpoint_dir(final):
        return final
    epochs = []
    for name in os.listdir(path):
        if name.startswith('checkpoint_epoch'):
            try:
                n = int(name[len('checkpoint_epoch'):])
            except ValueError:
                continue
            if _is_checkpoint_dir(os.path.join(path, name)):
                epochs.append(n)
    if epochs:
        return os.path.join(path, f'checkpoint_epoch{max(epochs)}')
    runs = sorted((os.path.join(path, d) for d in os.listdir(path)
                   if os.path.isdir(os.path.join(path, d))),
                  key=os.path.getmtime, reverse=True)
    for run in runs:
        found = find_latest_checkpoint(run)
        if found:
            return found
    return None


def load_checkpoint(path):
    """(state, cfg) of a checkpoint directory; state's tensors on the CPU. The
    config merges non-strictly: a key that is no longer a default is dropped with a
    warning, so that older checkpoints stay loadable."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _CFG_FILE)) as f:
        cfg = get_cfg(cfg_dict=json.load(f), cfg_dict_strict=False)
    state = torch.load(os.path.join(path, _STATE_DIR, _STATE_FILE), map_location='cpu',
                       weights_only=True)
    return state, cfg


def _torch_blob(path):
    blob = torch.load(path, map_location='cpu', weights_only=False)
    hparams = {}
    if isinstance(blob, dict):
        hparams = blob.get('hyper_parameters') or blob.get('hparams') or {}
        if 'state_dict' in blob:
            blob = blob['state_dict']
    sd = {k: torch.as_tensor(v) for k, v in blob.items()
          if isinstance(v, torch.Tensor) or hasattr(v, 'shape')}
    return sd, hparams


def _is_efficientnet(sd):
    return any(k.startswith(('_conv_stem', '_blocks.')) for k in sd)


def reference_state(sd, model):
    """A reference FIERY state_dict (Lightning names, ``model.`` prefix) -> (this
    package's Fiery state_dict, uncertainty weights). The port's modules carry the
    reference's names, so the model's entries lose their prefix; the frustum and
    the BEV constants, buffers the port does not save, are dropped, and a missing
    ``num_batches_tracked`` takes the model's."""
    model_sd, uncertainty = {}, {}
    for k, v in sd.items():
        name = k[len('model.'):] if k.startswith('model.') else k
        if name in UNCERTAINTY_KEYS:
            uncertainty[name] = v.reshape(())
        elif name != 'frustum' and not name.startswith('bev_'):
            model_sd[name] = v
    for k, v in model.state_dict().items():
        if k.endswith('num_batches_tracked') and k not in model_sd:
            model_sd[k] = v
    return model_sd, uncertainty


def load_torch_pretrained(path, trainer):
    """Warm start ``trainer`` from a torch ``.pth`` / ``.ckpt`` file. Two formats:
      * a standalone ImageNet EfficientNet state dict in efficientnet_pytorch naming
        (``_conv_stem.weight``, ``_blocks.N...``): the encoder's backbone only,
        the blocks past the encoder's cut and the classifier ignored;
      * a full reference FIERY checkpoint (a Lightning ``state_dict`` with
        ``model.`` keys): every entry it has, and the uncertainty weights.
    A shape that does not match raises either way."""
    sd, _ = _torch_blob(path)
    model = trainer.model
    if _is_efficientnet(sd):
        backbone = model.encoder.backbone
        own = backbone.state_dict()
        missing = [k for k in own if k not in sd and not k.endswith('num_batches_tracked')]
        if missing:
            raise KeyError(f'EfficientNet state dict missing {missing[:5]}')
        backbone.load_state_dict({k: sd.get(k, v) for k, v in own.items()}, strict=True)
        return trainer
    model_sd, uncertainty = reference_state(sd, model)
    model.load_state_dict(model_sd, strict=False)
    with torch.no_grad():
        for k, v in uncertainty.items():
            if k in trainer.uncertainty:
                trainer.uncertainty[k].copy_(v)
    return trainer


def load_torch_full_checkpoint(path, strict=True):
    """(state, cfg) from a reference Lightning checkpoint: the config rebuilt from
    its ``hyper_parameters`` (non-strict merge), the weights checked against a
    model built from that config (strict: every entry and no other), no Adam state
    and step 0."""
    sd, hparams = _torch_blob(path)
    cfg = get_cfg(cfg_dict=dict(hparams), cfg_dict_strict=False)
    model = Fiery(FieryConfig.from_cfg(cfg))
    model_sd, uncertainty = reference_state(sd, model)
    model.load_state_dict(model_sd, strict=strict)
    if strict:
        want = set(init_uncertainty_weights(cfg.INSTANCE_FLOW.ENABLED))
        if set(uncertainty) != want:
            raise KeyError(f'uncertainty weights {sorted(uncertainty)}, expected {sorted(want)}')
    return {'model': model.state_dict(), 'uncertainty': uncertainty, 'optimizer': None,
            'step': 0}, cfg


def load_pretrained_params(path, trainer):
    """Partial warm start (the reference's strict=False): copy every parameter of a
    checkpoint whose name and shape match into ``trainer`` and keep the rest; the
    running statistics and the Adam state stay. ``path``: a checkpoint directory or
    a torch ``.pth`` / ``.pt`` / ``.ckpt`` file (``load_torch_pretrained``)."""
    if path.endswith(('.pth', '.pt', '.ckpt')):
        return load_torch_pretrained(path, trainer)
    state, _ = load_checkpoint(path)
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            v = state['model'].get(name)
            if v is not None and v.shape == p.shape:
                p.copy_(v)
        for k, p in trainer.uncertainty.items():
            v = state['uncertainty'].get(k)
            if v is not None:
                p.copy_(v)
    return trainer
