"""Where the splat's time goes, by stage and by data: python -m fiery_tpu_torch.splat_stages

Builds the splat kernel (K1, csrc/bev_pool.cu) and times one bf16 forward call at
the baseline serve shapes (3 samples x 6 cameras x 28 x 60 pixels x 48 bins, C =
64, the seeded camera rig of ``serve.make_request``) on several sets of voxel ids:
the rig's own ('real'), uniform random ids, ids spread evenly over the voxels,
every row dumped, and the rig's ids with only the first or the last 8 depth bins
kept. For each it prints one JSON line: the device ms of every launch of the call
by stage (torch.profiler, 25 calls after 3 warm-ups), the in-grid rows, the voxels
with rows, those over 64 rows, and the largest bucket. Needs a CUDA card.
"""

import json

import torch

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.ops.lift_splat import bev_pool, bev_pool_order


def main():
    import chip_smoke as cs   # the repository root's measurement helpers
    if not torch.cuda.is_available():
        raise SystemExit('splat_stages needs a CUDA card')
    _build.build_all(['bev_pool'])
    dev = torch.device('cuda')
    depth, feat, ids, nb, z = cs.bev_pool_inputs(dev)
    depth, feat = depth.to(torch.bfloat16), feat.to(torch.bfloat16)
    D = ids.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    bins = torch.arange(D, device=dev)
    cases = {
        'real': ids,
        'uniform': torch.randint(0, nb + 1, ids.shape, generator=gen, device=dev,
                                 dtype=torch.int32),
        'spread': (torch.arange(ids.numel(), device=dev, dtype=torch.int32).view(ids.shape)
                   % nb).contiguous(),
        'dumped': torch.full_like(ids, nb),
        'real_first8': torch.where(bins < 8, ids, nb).to(torch.int32).contiguous(),
        'real_last8': torch.where(bins >= D - 8, ids, nb).to(torch.int32).contiguous(),
    }
    print(cs.smi_line(), flush=True)
    for name, i in cases.items():
        _, offsets = bev_pool_order(i, nb, z)
        sizes = offsets[1:] - offsets[:-1]
        ms, stages = cs.k1_ms(lambda i=i: bev_pool(depth, feat, i, nb, z))
        print(json.dumps({'case': name, 'ms': ms, **stages, 'rows': int(offsets[-1]),
                          'voxels': int((sizes > 0).sum()), 'over64': int((sizes > 64).sum()),
                          'largest': int(sizes.max())}), flush=True)


if __name__ == '__main__':
    main()
