"""Self-contained nuScenes index over the dataset's plain-JSON tables (a copy of
fiery_tpu/data/nuscenes_indexer.py).

No nuscenes-devkit is needed. The dataset touches a narrow interface (``.sample``,
``.scene``, ``.get(table, token)``, ``.version``, ``.dataroot``), which this index
provides by reading ``<dataroot>/<version>/*.json`` and adding the devkit's
derived fields:

  * ``sample['data']``  - keyframe channel -> sample_data token map
  * ``sample['anns']``  - annotation tokens of the sample (table order)
  * ``sample_data['channel']`` / ``['sensor_modality']`` - via calibrated_sensor -> sensor
  * ``sample_annotation['category_name']`` - via instance -> category

The official scene splits (train/val/mini_train/mini_val) come from
``create_splits_scenes()``: the mini splits are inlined (public constants); the
850-scene trainval split cannot be derived from the data, so it is read from the
installed devkit when there is one, else from a user-supplied
``splits_scenes.json`` (the error message gives the one-liner that writes it).
The index pickles, so that the loader's worker processes receive it.
"""

import json
import os

TABLE_NAMES = ('category', 'attribute', 'visibility', 'instance', 'sensor',
               'calibrated_sensor', 'ego_pose', 'log', 'scene', 'sample',
               'sample_data', 'sample_annotation')

# Public nuScenes v1.0-mini split constants (devkit nuscenes/utils/splits.py).
MINI_TRAIN = ['scene-0061', 'scene-0553', 'scene-0655', 'scene-0757',
              'scene-0796', 'scene-1077', 'scene-1094', 'scene-1100']
MINI_VAL = ['scene-0103', 'scene-0916']


class NuScenesIndex:
    """Drop-in replacement for ``nuscenes.nuscenes.NuScenes`` (indexing subset).

    version: full version string, e.g. ``v1.0-mini`` / ``v1.0-trainval``.
    dataroot: directory that contains the ``<version>/`` table dir and the
    ``samples/``/``sweeps/`` media dirs.
    table_root: explicit table directory override. The Lyft Level-5 dataset
    uses the exact same JSON table schema but keeps its tables in
    ``<dataroot>/train_data`` instead of ``<dataroot>/<version>`` (the Lyft
    SDK's ``json_path``); passing it here makes this index a drop-in for ``LyftDataset`` too —
    no SDK import anywhere in the real-data path.
    """

    def __init__(self, version, dataroot, verbose=False, table_root=None):
        self.version = version
        self.dataroot = dataroot
        self.data_path = dataroot   # LyftDataset-compatible alias
        table_root = table_root or os.path.join(dataroot, version)
        if not os.path.isdir(table_root):
            raise FileNotFoundError(
                f'nuScenes table dir not found: {table_root} '
                f'(expected <dataroot>/<version>/*.json)')

        self._tables = {}
        self._index = {}
        for name in TABLE_NAMES:
            path = os.path.join(table_root, name + '.json')
            if not os.path.exists(path):
                # visibility/attribute/log may be absent in stripped-down trees
                self._tables[name] = []
                self._index[name] = {}
                continue
            with open(path) as f:
                records = json.load(f)
            self._tables[name] = records
            self._index[name] = {rec['token']: rec for rec in records}
        if verbose:
            for name in TABLE_NAMES:
                print(f'{len(self._tables[name])} {name}')

        self._decorate()

    # -- devkit-parity derived fields -----------------------------------
    def _decorate(self):
        # sample_annotation.category_name via instance -> category
        for ann in self._tables['sample_annotation']:
            instance = self._index['instance'][ann['instance_token']]
            category = self._index['category'][instance['category_token']]
            ann['category_name'] = category['name']

        # sample_data.channel / sensor_modality via calibrated_sensor -> sensor
        for sd in self._tables['sample_data']:
            cal = self._index['calibrated_sensor'][sd['calibrated_sensor_token']]
            sensor = self._index['sensor'][cal['sensor_token']]
            sd['channel'] = sensor['channel']
            sd['sensor_modality'] = sensor['modality']

        # sample.data (keyframes) and sample.anns, in table order like the devkit
        for sample in self._tables['sample']:
            sample['data'] = {}
            sample['anns'] = []
        for sd in self._tables['sample_data']:
            if sd['is_key_frame']:
                self._index['sample'][sd['sample_token']]['data'][sd['channel']] = (
                    sd['token'])
        for ann in self._tables['sample_annotation']:
            self._index['sample'][ann['sample_token']]['anns'].append(ann['token'])

    # -- public interface ------------------------------------------------
    @property
    def sample(self):
        return self._tables['sample']

    @property
    def scene(self):
        return self._tables['scene']

    def get(self, table_name, token):
        return self._index[table_name][token]

    def __getattr__(self, name):
        # expose remaining tables as attributes (devkit style: nusc.ego_pose, ...)
        tables = self.__dict__.get('_tables', {})
        if name in tables:
            return tables[name]
        raise AttributeError(name)


def create_splits_scenes():
    """Official scene-name splits, devkit-compatible dict.

    mini_train/mini_val are inlined. The 700/150-scene train/val lists are code
    constants in the devkit (not derivable from the data), so they are resolved
    from (a) the installed devkit if importable, or (b) a ``splits_scenes.json``
    in the current directory or ``$FIERY_SPLITS_JSON``.
    """
    try:
        from nuscenes.utils.splits import create_splits_scenes as devkit_splits
        return devkit_splits()
    except ImportError:
        pass
    for candidate in (os.environ.get('FIERY_SPLITS_JSON', ''),
                      'splits_scenes.json'):
        if candidate and os.path.exists(candidate):
            with open(candidate) as f:
                splits = json.load(f)
            splits.setdefault('mini_train', MINI_TRAIN)
            splits.setdefault('mini_val', MINI_VAL)
            return splits
    return {
        'mini_train': MINI_TRAIN,
        'mini_val': MINI_VAL,
        'train': _missing_split('train'),
        'val': _missing_split('val'),
    }


class _missing_split(list):
    """Empty split that raises with instructions when actually used."""

    def __init__(self, name):
        super().__init__()
        self.name = name

    def _explain(self):
        raise RuntimeError(
            f'The official nuScenes {self.name!r} split table is a devkit code '
            f'constant and is not available here. Either pip install '
            f'nuscenes-devkit, or on any machine that has it run:\n'
            f"  python -c \"import json; from nuscenes.utils.splits import "
            f"create_splits_scenes as s; json.dump(s(), "
            f"open('splits_scenes.json','w'))\"\n"
            f'and drop splits_scenes.json next to your working directory '
            f'(or point $FIERY_SPLITS_JSON at it).')

    def __iter__(self):
        self._explain()

    def __contains__(self, item):
        self._explain()
