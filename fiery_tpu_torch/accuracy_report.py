"""Format the JSON of fiery_tpu_torch.accuracy_ab as the README's markdown tables
(counterpart of tools/accuracy_report.py, whose text it prints for the same JSON),
or hold a multi-seed train study against another's (the JAX harness's r5 run):

    python -m fiery_tpu_torch.accuracy_report TRAIN_JSON [ACTIVATION_JSON]
    python -m fiery_tpu_torch.accuracy_report --against REFERENCE_JSON TRAIN_JSON
"""
import json
import sys


def fmt(x, nd=3):
    return f'{x:.{nd}f}'


def main(train_json, act_json=None):
    with open(train_json) as f:
        tr = json.load(f)
    res = tr['results']
    multi_seed = 'per_seed' in res['dense']   # round-5 multi-seed schema
    if multi_seed:
        dense = res['dense']['per_seed'][0]['eval_dense_parity']
        seeds = tr.get('seeds', [0])
        print(f"Trained for {tr['steps']} steps x {len(seeds)} seeds on the "
              f"learnable synthetic set ({tr['n_train']} train / "
              f"{tr['n_val']} val scripted scenes), full eval protocol "
              f"(zero-noise, host instance matching); mean +- seed sd:\n")
        print('| trained with | IoU mean +- sd | VPQ mean +- sd |')
        print('|---|---|---|')
        for mode, row in res.items():
            if mode == 'dense_trained_cross_serving':
                continue
            i, v = row['iou_matched'], row['vpq_matched']
            print(f"| {mode} | {fmt(i['mean'])} +- {fmt(i['sd'])} "
                  f"| {fmt(v['mean'])} +- {fmt(v['sd'])} |")
    else:
        dense = res['dense']['eval_dense_parity']
        print(f"Trained from one shared init for {tr['steps']} steps on the "
              f"learnable synthetic set ({tr['n_train']} train / {tr['n_val']} "
              f"val scripted scenes), evaluated with the full protocol "
              f"(zero-noise, host instance matching):\n")
        print('| trained with | served with its own config (IoU / VPQ) | '
              'served dense (IoU / VPQ) |')
        print('|---|---|---|')
        for mode, row in res.items():
            if mode == 'dense_trained_cross_serving':
                continue
            m, d = row['eval_matched'], row['eval_dense_parity']
            print(f"| {mode} | {fmt(m['iou'])} / {fmt(m['vpq'])} "
                  f"| {fmt(d['iou'])} / {fmt(d['vpq'])} |")
    print('\nDense-trained checkpoint cross-served with each lever '
          '(the pure serving-lever case):\n')
    print('| served with | IoU | VPQ | ΔIoU vs dense-served |')
    print('|---|---|---|---|')
    for serve, row in res['dense_trained_cross_serving'].items():
        print(f"| {serve} | {fmt(row['iou'])} | {fmt(row['vpq'])} "
              f"| {row['iou'] - dense['iou']:+.3f} |")
    if act_json:
        with open(act_json) as f:
            act = json.load(f)
        print('\nActivation-error study (BEV features / seg logits, relative '
              'to the global max, dense reference):\n')
        print('| state | depth entropy p50 (nats) | top-8 mass p50 | lever | '
              'BEV err p50 / p99 | seg-logit err p50 / p99 |')
        print('|---|---|---|---|---|---|')
        for tag, row in act.items():
            if tag == 'device':            # the card's name and power limit
                continue
            ent = row['depth_entropy_nats']
            mass = row['top8_captured_mass']
            for lever in ['topk8', 'warpfree', 'topk8_warpfree']:
                bev = row[f'bev_feature_rel_err_{lever}']
                seg = row.get(f'seg_logit_rel_err_{lever}')
                segtxt = (f"{fmt(seg['p50'], 4)} / {fmt(seg['p99'], 4)}"
                          if seg else '—')
                print(f"| {tag} | {fmt(ent['p50'], 2)} | {fmt(mass['p50'], 3)} "
                      f"| {lever} | {fmt(bev['p50'], 4)} / {fmt(bev['p99'], 4)} "
                      f"| {segtxt} |")


def compare(train_json, reference_json):
    """Each mode's IoU and VPQ means (served matched) against the reference run's:
    the difference in units of the combined seed sd, the root of the two runs'
    seed variances."""
    with open(train_json) as f:
        ours = json.load(f)['results']
    with open(reference_json) as f:
        theirs = json.load(f)['results']
    print('| trained with | IoU | reference IoU | difference / combined sd | VPQ | '
          'reference VPQ | difference / combined sd |')
    print('|---|---|---|---|---|---|---|')
    for mode, row in ours.items():
        if mode == 'dense_trained_cross_serving' or mode not in theirs:
            continue
        cells = []
        for key in ('iou_matched', 'vpq_matched'):
            a, b = row[key], theirs[mode][key]
            sd = (a['sd'] ** 2 + b['sd'] ** 2) ** 0.5
            z = f"{(a['mean'] - b['mean']) / sd:+.2f}" if sd > 0 else 'n/a'
            cells.append(f"{fmt(a['mean'])} +- {fmt(a['sd'])} | "
                         f"{fmt(b['mean'])} +- {fmt(b['sd'])} | {z}")
        print(f"| {mode} | {' | '.join(cells)} |")


if __name__ == '__main__':
    if sys.argv[1] == '--against':
        compare(sys.argv[3], sys.argv[2])
    else:
        main(*sys.argv[1:])
