"""Each module of fiery_tpu_torch against its JAX twin, with the JAX package's weights
converted by state_dict_from_jax (CPU, f32, channels-last in and out).

Tolerance rtol/atol 1e-4 on every output.
"""

import jax
import numpy as np
import pytest
import torch

from fiery_tpu.models.decoder import Decoder
from fiery_tpu.models.distributions import DistributionModule
from fiery_tpu.models.encoder import Encoder
from fiery_tpu.models.future_prediction import FuturePrediction
from fiery_tpu.models.temporal_model import TemporalModel

from test_torch_fiery import TINY, _randomize_stats, jax_tiny_model, ported_tiny_model


@pytest.fixture(scope='module')
def tiny():
    _, _, variables = jax_tiny_model(seed=2)
    return variables, ported_tiny_model(variables)


def _sub(variables, *path):
    params, stats = variables['params'], variables['batch_stats']
    for k in path:
        params, stats = params[k], stats[k]
    return {'params': params, 'batch_stats': stats}


def _apply(module, variables, *args, **kw):
    return jax.jit(lambda v, *a: module.apply(v, *a, train=False, **kw))(variables, *args)


def _close(got, want, name):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


def test_encoder_b0(tiny):
    variables, model = tiny
    x = np.random.RandomState(10).randn(2, 64, 96, 3).astype(np.float32)
    depth, feat = _apply(Encoder(out_channels=16, depth_channels=6, version='b0',
                                 downsample=8), _sub(variables, 'bev_lift', 'encoder'), x,
                         split_depth=True)
    with torch.no_grad():
        got_depth, got_feat = model.encoder(torch.from_numpy(x))
    _close(got_depth, depth, 'depth')
    _close(got_feat, feat, 'features')


def test_temporal_model_trimmed(tiny):
    variables, model = tiny
    x = np.random.RandomState(11).randn(1, 3, 32, 32, 22).astype(np.float32)
    want = _apply(TemporalModel(receptive_field=3, input_shape=(32, 32),
                                start_out_channels=16),
                  _sub(variables, 'temporal_model'), x, trim=True)
    with torch.no_grad():
        got = model.temporal_model(torch.from_numpy(x), trim=True)
        untrimmed = model.temporal_model(torch.from_numpy(x))
    assert got.shape == (1, 1, 32, 32, 16)
    _close(got, want, 'temporal')
    # the trim is exact at eval: the same present frame as the full stack
    torch.testing.assert_close(got, untrimmed, rtol=1e-5, atol=1e-5)


def test_present_distribution(tiny):
    variables, model = tiny
    x = np.random.RandomState(12).randn(1, 1, 32, 32, 16).astype(np.float32)
    mu, log_sigma = _apply(DistributionModule(latent_dim=4),
                           _sub(variables, 'present_distribution'), x)
    with torch.no_grad():
        got_mu, got_ls = model.present_distribution(torch.from_numpy(x))
    _close(got_mu, mu, 'mu')
    _close(got_ls, log_sigma, 'log_sigma')


def test_future_prediction(tiny):
    variables, model = tiny
    rng = np.random.RandomState(13)
    x = rng.randn(1, TINY['n_future_frames'], 32, 32, 4).astype(np.float32)
    hidden = rng.randn(1, 32, 32, 16).astype(np.float32)
    want = _apply(FuturePrediction(in_channels=16, n_gru_blocks=1, n_res_layers=2),
                  _sub(variables, 'future_prediction'), x, hidden)
    with torch.no_grad():
        got = model.future_prediction(torch.from_numpy(x), torch.from_numpy(hidden))
    _close(got, want, 'future_prediction')


def test_decoder(tiny):
    variables, model = tiny
    x = np.random.RandomState(14).randn(1, 3, 32, 32, 16).astype(np.float32)
    want = _apply(Decoder(n_classes=2, predict_future_flow=True),
                  _sub(variables, 'decoder'), x)
    with torch.no_grad():
        got = model.decoder(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k], k)


def test_causal_max_pool3d():
    from fiery_tpu.models.temporal_layers import causal_max_pool3d as jax_pool
    from fiery_tpu_torch.models.temporal_layers import causal_max_pool3d
    x = np.random.RandomState(15).randn(2, 4, 9, 10, 3).astype(np.float32)
    want = np.asarray(jax.jit(jax_pool)(x))
    got = causal_max_pool3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('out_channels', [8, 12])
def test_bottleneck3d(out_channels):
    """Bottleneck3D (the spatial layers between temporal blocks) with the JAX
    module's initial weights and randomised BN statistics, mapped by hand."""
    from fiery_tpu.models.temporal_layers import Bottleneck3D as JaxBottleneck3D
    from fiery_tpu_torch.models.temporal_layers import Bottleneck3D
    from fiery_tpu_torch.utils.weight_import import _to_torch_layout

    rng = np.random.RandomState(16)
    x = rng.randn(1, 3, 12, 12, 8).astype(np.float32)
    jmod = JaxBottleneck3D(out_channels=out_channels, kernel_size=(2, 3, 3))
    v = jax.tree.map(np.asarray, jax.jit(lambda k: jmod.init(k, x))(jax.random.key(3)))
    variables = {'params': v['params'],
                 'batch_stats': _randomize_stats(v['batch_stats'], rng)}
    want = jax.jit(lambda vv: jmod.apply(vv, x, train=False))(variables)

    model = Bottleneck3D(8, out_channels, kernel_size=(2, 3, 3)).eval()
    P, S = variables['params'], variables['batch_stats']

    def load_bn(bn, p, s):
        bn.weight.data = torch.tensor(p['BatchNorm_0']['scale'])
        bn.bias.data = torch.tensor(p['BatchNorm_0']['bias'])
        bn.running_mean.data = torch.tensor(s['BatchNorm_0']['mean'])
        bn.running_var.data = torch.tensor(s['BatchNorm_0']['var'])

    for name, jname, kind in [('conv_down_project', 'Conv1x1x1NormActivated_0', 'conv3d_1x1'),
                              ('conv', 'CausalConv3d_0', 'conv3d_causal_kt2'),
                              ('conv_up_project', 'Conv1x1x1NormActivated_1', 'conv3d_1x1')]:
        layer = getattr(model.layers, name)
        layer.conv.weight.data = torch.tensor(
            _to_torch_layout(P[jname]['Conv_0']['kernel'], kind))
        load_bn(layer.norm, P[jname]['BatchNorm_0'], S[jname]['BatchNorm_0'])
    if out_channels != 8:
        model.projection[0].weight.data = torch.tensor(
            _to_torch_layout(P['Conv_0']['kernel'], 'conv3d_1x1'))
        load_bn(model.projection[1], P['BatchNorm_0'], S['BatchNorm_0'])
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    _close(got, want, 'bottleneck3d')


@pytest.mark.parametrize('dims', [4, 5])
def test_batchnorm_train_statistics_match_jax(dims):
    """One train-mode forward: the output and the new running statistics equal the
    JAX BatchNorm's (biased batch variance, the same momentum); so does eval with
    the new running statistics, which is also bit for bit _BNCore's formula,
    (x - mean) * (scale / sqrt(var + eps)) + bias, in f32."""
    from fiery_tpu.models.layers import BatchNorm as JaxBatchNorm
    from fiery_tpu_torch.models.layers import BatchNorm
    rng = np.random.RandomState(20 + dims)
    shape = (3, 5, 6, 7) if dims == 4 else (2, 3, 5, 6, 7)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)       # channels-last, C = 7
    scale, bias = rng.rand(7).astype(np.float32) + 0.5, rng.randn(7).astype(np.float32)
    mean, var = rng.randn(7).astype(np.float32), rng.rand(7).astype(np.float32) + 0.5
    variables = {'params': {'BatchNorm_0': {'scale': scale, 'bias': bias}},
                 'batch_stats': {'BatchNorm_0': {'mean': mean, 'var': var}}}
    want, new = JaxBatchNorm(momentum=0.05).apply(variables, x, train=True,
                                                  mutable=['batch_stats'])
    bn = BatchNorm(7, momentum=0.05).train()
    with torch.no_grad():
        for p, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            p.copy_(torch.from_numpy(v))
        xt = torch.from_numpy(x).movedim(-1, 1)
        got = bn(xt).movedim(1, -1)
    _close(got, want, 'train output')
    np.testing.assert_allclose(bn.running_mean.numpy(), new['batch_stats']['BatchNorm_0']['mean'],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new['batch_stats']['BatchNorm_0']['var'],
                               rtol=1e-5, atol=1e-6)
    want = JaxBatchNorm(momentum=0.05).apply(
        {'params': variables['params'], 'batch_stats': new['batch_stats']}, x, train=False)
    with torch.no_grad():
        got = bn.eval()(xt).movedim(1, -1)
    _close(got, want, 'eval output')
    rm, rv = bn.running_mean.numpy(), bn.running_var.numpy()
    mul = scale * (np.float32(1.0) / np.sqrt(rv + np.float32(1e-5)))
    torch.testing.assert_close(got, torch.from_numpy((x - rm) * mul + bias), rtol=0, atol=0)


def test_drop_connect():
    """Block i of n drops with rate 0.2 i / n; a training skip block keeps or drops
    its whole residual branch per sample (kept branches scaled by 1 / keep), with the
    uniforms drawn from the generator; eval and non-skip blocks never drop."""
    from fiery_tpu_torch.models.efficientnet import EfficientNetFPN, MBConvBlock
    from fiery_tpu_torch.serve import init_params
    net = EfficientNetFPN('b0', 8)
    n = len(net._blocks)
    assert [b.drop_rate for b in net._blocks] == [0.2 * i / n for i in range(n)]
    block = init_params(MBConvBlock(3, 1, 6, 16, 16, 0.25, drop_rate=0.4), seed=1).train()
    x = torch.from_numpy(np.random.RandomState(30).randn(64, 16, 6, 5).astype(np.float32))
    with torch.no_grad():
        block.drop_rate = 0.0
        branch = block(x) - x
        block.drop_rate = 0.4
        got = block(x, torch.Generator().manual_seed(7))
        keep = torch.rand((64, 1, 1, 1), generator=torch.Generator().manual_seed(7)) < 0.6
        torch.testing.assert_close(got, x + branch / 0.6 * keep, rtol=1e-5, atol=1e-5)
        assert 10 < int(keep.sum()) < 54
        block.eval()
        dropped_at_eval = block(x, torch.Generator().manual_seed(7))
        block.drop_rate = 0.0
        torch.testing.assert_close(dropped_at_eval, block(x), rtol=0, atol=0)
        proj = MBConvBlock(3, 2, 6, 16, 24, 0.25, drop_rate=0.4).train()
        a = proj(x, torch.Generator().manual_seed(7))
        torch.testing.assert_close(proj(x, torch.Generator().manual_seed(8)), a)
