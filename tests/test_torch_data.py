"""fiery_tpu_torch.data (the synthetic dataset and its label generation) against
fiery_tpu.data: the same arrays for the same configuration and seed."""

import numpy as np

from fiery_tpu.data.synthetic import SyntheticFutureDataset as JaxSyntheticFutureDataset
from fiery_tpu.data import labels as jax_labels
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu_torch.data import labels
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.utils.config import get_cfg
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

SMALL = {'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 2,
         'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_A', 'CAM_B', 'CAM_C']},
         'LIFT': {'X_BOUND': [-12.0, 12.0, 0.5], 'Y_BOUND': [-10.0, 10.0, 0.5]}}


def test_synthetic_dataset_equals_jax():
    cfg, jcfg = get_cfg(cfg_dict=SMALL), jax_get_cfg(cfg_dict=SMALL)
    ours = SyntheticFutureDataset(cfg, n_samples=3, n_instances=4, seed=11)
    ref = JaxSyntheticFutureDataset(jcfg, n_samples=3, n_instances=4, seed=11)
    got, want = ours.get_batch([0, 2]), ref.get_batch([0, 2])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got['image'].shape == (2, 5, 3, 64, 96, 3) and got['image'].dtype == np.uint8
    assert got['instance'].max() >= 1 and (got['offset'] == 255).any()


def test_instance_labels_equal_jax_under_ego_motion():
    """Centerness, offsets and the ego-compensated future flow, with a rotation and
    a translation large enough to move instances across pixels."""
    rng = np.random.RandomState(3)
    instance = np.zeros((4, 40, 36), np.int32)
    for i in range(1, 6):
        x, y = rng.randint(4, 30, 2)
        for t in range(4):
            instance[t, x + t:x + t + 4, y:y + 3] = i
    ego = np.zeros((4, 6), np.float32)
    ego[:, 0] = 1.3
    ego[:, 5] = 0.05
    kw = dict(num_instances=5, ignore_index=255, spatial_extent=(10.0, 9.0))
    for a, b in zip(labels.convert_instance_mask_to_center_and_offset_label(instance, ego, **kw),
                    jax_labels.convert_instance_mask_to_center_and_offset_label(instance, ego,
                                                                                 **kw)):
        np.testing.assert_array_equal(a, b)
