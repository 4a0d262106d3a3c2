"""Hierarchical configuration system (yacs-style) for fiery_tpu_torch.

A copy of fiery_tpu/utils/config.py, so that the PyTorch package reads the same
YAML files with the same defaults without importing the JAX package: defaults +
recursive ``_BASE_`` YAML inheritance + positional ``KEY VALUE`` CLI overrides,
with ``freeze()`` after merging.
"""

import argparse
import ast
import copy
import os

import yaml

_IMMUTABLE = '__immutable__'
_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """A dict with attribute access, freezing, YAML ``_BASE_`` inheritance and CLI merging."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, _IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute access ------------------------------------------------
    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(f'Config key not found: {name}')

    def __setattr__(self, name, value):
        if self.is_frozen():
            raise AttributeError(f'Attempted to set {name} on an immutable CfgNode.')
        self[name] = value

    def __setitem__(self, key, value):
        # default False via __dict__.get, NOT getattr: pickle restores dict
        # items (SETITEMS) before instance state (BUILD), so during unpickling
        # __setitem__ runs with no _IMMUTABLE attribute yet — getattr would
        # fall through to __getattr__ and raise (observed: DataLoader worker
        # processes died unpickling their dataset's cfg).
        if self.__dict__.get(_IMMUTABLE, False):
            raise AttributeError(f'Attempted to set {key} on an immutable CfgNode.')
        dict.__setitem__(self, key, value)

    # -- mutability ------------------------------------------------------
    def freeze(self):
        object.__setattr__(self, _IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self):
        object.__setattr__(self, _IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self):
        return self.__dict__.get(_IMMUTABLE, False)

    def clone(self):
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode()
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    # -- merging ---------------------------------------------------------
    def merge_from_other_cfg(self, other):
        _merge_a_into_b(other, self, strict=True)

    def merge_from_dict(self, d, strict=True):
        """strict=False (checkpoint-restore path): unknown keys are warned about and
        dropped instead of raising, so removing/renaming a default key never makes
        older checkpoints unloadable. User-facing YAML/CLI merges stay strict."""
        _merge_a_into_b(CfgNode(d), self, strict=strict,
                        drop_unknown=not strict)

    def merge_from_file(self, filename):
        loaded = _load_yaml_with_base(filename)
        _merge_a_into_b(loaded, self, strict=True)

    def merge_from_list(self, opts):
        """Merge from a flat list ['KEY', 'VALUE', 'KEY.SUBKEY', 'VALUE', ...]."""
        if opts is None:
            return
        assert len(opts) % 2 == 0, f'Override list has odd length: {opts}'
        for full_key, v in zip(opts[0::2], opts[1::2]):
            key_parts = full_key.split('.')
            node = self
            for part in key_parts[:-1]:
                if part not in node:
                    raise KeyError(f'Non-existent config key: {full_key}')
                node = node[part]
            last = key_parts[-1]
            if last not in node:
                raise KeyError(f'Non-existent config key: {full_key}')
            value = _decode_value(v)
            node[last] = _coerce_value_type(value, node[last], full_key)

    # -- export ----------------------------------------------------------
    def convert_to_dict(self):
        """Recursively convert to a plain dict."""
        out = {}
        for k, v in self.items():
            if isinstance(v, CfgNode):
                out[k] = v.convert_to_dict()
            else:
                if not isinstance(v, _VALID_TYPES):
                    raise TypeError(f'Key {k} with value {v!r} is not a valid config type.')
                out[k] = v
        return out

    def dump_yaml(self):
        return yaml.safe_dump(self.convert_to_dict(), default_flow_style=None)


def _decode_value(v):
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce_value_type(new, old, full_key):
    """Coerce overriding value to the type of the default, where sensible."""
    if old is None or new is None:
        return new
    if type(new) == type(old):
        return new
    # permissive casts matching yacs behaviour
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, bool) and isinstance(new, str):
        if new.lower() in ('true', '1'):
            return True
        if new.lower() in ('false', '0'):
            return False
    raise ValueError(
        f'Type mismatch for key {full_key}: cannot coerce {type(new).__name__} '
        f'({new!r}) to {type(old).__name__} ({old!r})'
    )


def _merge_a_into_b(a, b, strict=False, _prefix='', drop_unknown=False):
    """Merge a into b. With ``strict`` (the user-facing merge paths), a key absent
    from b raises — matching the reference's yacs 'Non-existent config key' behaviour
    (fvcore CfgNode; a typo'd YAML/override key must not be silently accepted).
    ``_BASE_`` resolution merges non-strictly (the base may not predate the child).
    With ``drop_unknown`` (checkpoint restore), unknown keys warn and are skipped."""
    for k, v in a.items():
        full_key = _prefix + k
        if strict and k not in b:
            raise KeyError(f'Non-existent config key: {full_key}')
        if drop_unknown and k not in b:
            import warnings
            warnings.warn(f'Dropping unknown config key from checkpoint: {full_key}')
            continue
        if isinstance(v, (dict, CfgNode)) and k in b and isinstance(b[k], CfgNode):
            _merge_a_into_b(v, b[k], strict=strict, _prefix=full_key + '.',
                            drop_unknown=drop_unknown)
        else:
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            if k in b and b[k] is not None and v is not None and not isinstance(v, CfgNode):
                v = _coerce_value_type(_decode_value(v), b[k], k)
            dict.__setitem__(b, k, v)


def _load_yaml_with_base(filename):
    """Load a YAML config, recursively resolving ``_BASE_`` inheritance."""
    with open(filename, 'r') as f:
        cfg = yaml.safe_load(f) or {}
    base_cfg = CfgNode()
    if '_BASE_' in cfg:
        base_path = cfg.pop('_BASE_')
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(filename), base_path)
        base_cfg = _load_yaml_with_base(base_path)
    _merge_a_into_b(CfgNode(cfg), base_cfg)
    return base_cfg


CN = CfgNode

# ---------------------------------------------------------------------------
# Defaults: the same keys and values as fiery_tpu/utils/config.py.
# ---------------------------------------------------------------------------
_C = CN()
_C.LOG_DIR = 'tensorboard_logs'
_C.TAG = 'default'

_C.GPUS = [0]
_C.PRECISION = 32        # 16 -> bf16 compute, 32 -> f32
_C.BATCHSIZE = 3
_C.EPOCHS = 20

_C.N_WORKERS = 5
_C.VIS_INTERVAL = 5000
_C.LOGGING_INTERVAL = 500

_C.PRETRAINED = CN()
_C.PRETRAINED.LOAD_WEIGHTS = False
_C.PRETRAINED.PATH = ''

_C.DATASET = CN()
_C.DATASET.DATAROOT = './nuscenes/'
_C.DATASET.VERSION = 'trainval'
_C.DATASET.NAME = 'nuscenes'
_C.DATASET.IGNORE_INDEX = 255
_C.DATASET.FILTER_INVISIBLE_VEHICLES = True
_C.DATASET.N_SYNTHETIC_SAMPLES = 16  # synthetic backend only
_C.DATASET.LABEL_CACHE_DIR = ''  # cache rasterised BEV labels on disk ('' = off)
_C.DATASET.PREWARP_LABELS = False
_C.DATASET.FAST_DECODE = False

_C.TIME_RECEPTIVE_FIELD = 3
_C.N_FUTURE_FRAMES = 4

_C.IMAGE = CN()
_C.IMAGE.FINAL_DIM = (224, 480)
_C.IMAGE.RESIZE_SCALE = 0.3
_C.IMAGE.TOP_CROP = 46
_C.IMAGE.ORIGINAL_HEIGHT = 900
_C.IMAGE.ORIGINAL_WIDTH = 1600
_C.IMAGE.NAMES = ['CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
                  'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT']
# lyft configs override these
_C.IMAGE.H = 900
_C.IMAGE.W = 1600

_C.LIFT = CN()
_C.LIFT.X_BOUND = [-50.0, 50.0, 0.5]   # forward
_C.LIFT.Y_BOUND = [-50.0, 50.0, 0.5]   # sides
_C.LIFT.Z_BOUND = [-10.0, 10.0, 20.0]  # height
_C.LIFT.D_BOUND = [2.0, 50.0, 1.0]
_C.LIFT.DEPTH_CULL = False
_C.LIFT.TOPK = 0
_C.LIFT.WARP_FREE = False
_C.LIFT.CULL_T_MARGIN = 0.5      # metres of translation slack in the envelope
_C.LIFT.CULL_ROT_MARGIN = 2.0    # degrees of rotation slack

_C.MODEL = CN()
_C.MODEL.ENCODER = CN()
_C.MODEL.ENCODER.DOWNSAMPLE = 8
_C.MODEL.ENCODER.NAME = 'efficientnet-b4'
_C.MODEL.ENCODER.OUT_CHANNELS = 64
_C.MODEL.ENCODER.USE_DEPTH_DISTRIBUTION = True

_C.MODEL.TEMPORAL_MODEL = CN()
_C.MODEL.TEMPORAL_MODEL.NAME = 'temporal_block'
_C.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS = 64
_C.MODEL.TEMPORAL_MODEL.EXTRA_IN_CHANNELS = 0
_C.MODEL.TEMPORAL_MODEL.INBETWEEN_LAYERS = 0
_C.MODEL.TEMPORAL_MODEL.PYRAMID_POOLING = True
_C.MODEL.TEMPORAL_MODEL.INPUT_EGOPOSE = True
_C.MODEL.TEMPORAL_MODEL.TRIM_TRAIN = False

_C.MODEL.DISTRIBUTION = CN()
_C.MODEL.DISTRIBUTION.LATENT_DIM = 32
_C.MODEL.DISTRIBUTION.MIN_LOG_SIGMA = -5.0
_C.MODEL.DISTRIBUTION.MAX_LOG_SIGMA = 5.0

_C.MODEL.FUTURE_PRED = CN()
_C.MODEL.FUTURE_PRED.N_GRU_BLOCKS = 3
_C.MODEL.FUTURE_PRED.N_RES_LAYERS = 3

_C.MODEL.DECODER = CN()

_C.MODEL.BN_MOMENTUM = 0.1
_C.MODEL.SUBSAMPLE = False

_C.SEMANTIC_SEG = CN()
_C.SEMANTIC_SEG.WEIGHTS = [1.0, 2.0]
_C.SEMANTIC_SEG.USE_TOP_K = True
_C.SEMANTIC_SEG.TOP_K_RATIO = 0.25

_C.INSTANCE_SEG = CN()

_C.INSTANCE_FLOW = CN()
_C.INSTANCE_FLOW.ENABLED = True

_C.PROBABILISTIC = CN()
_C.PROBABILISTIC.ENABLED = True
_C.PROBABILISTIC.WEIGHT = 100.0
_C.PROBABILISTIC.FUTURE_DIM = 6

_C.FUTURE_DISCOUNT = 0.95

_C.OPTIMIZER = CN()
_C.OPTIMIZER.LR = 3e-4
_C.OPTIMIZER.WEIGHT_DECAY = 1e-7
_C.GRAD_NORM_CLIP = 5


def get_parser():
    parser = argparse.ArgumentParser(description='fiery_tpu_torch')
    parser.add_argument('--config-file', default='', metavar='FILE', help='path to config file')
    parser.add_argument(
        'opts', help='Modify config options from the command line', default=None,
        nargs=argparse.REMAINDER,
    )
    return parser


def get_cfg(args=None, cfg_dict=None, cfg_dict_strict=True):
    """Defaults <- cfg_dict <- YAML file <- CLI KEY VALUE overrides.

    ``cfg_dict_strict=False`` is the checkpoint-restore path: stale keys from older
    checkpoints are dropped with a warning instead of raising."""
    cfg = _C.clone()
    if cfg_dict is not None:
        cfg.merge_from_dict(cfg_dict, strict=cfg_dict_strict)
    if args is not None:
        if getattr(args, 'config_file', ''):
            cfg.merge_from_file(args.config_file)
        cfg.merge_from_list(args.opts)
        cfg.freeze()
    return cfg
