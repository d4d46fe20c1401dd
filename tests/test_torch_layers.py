"""segtpu_torch core + ops vs the JAX package, on the CPU in f32.

Same seeded numpy inputs and weights through both; conv-bn-act blocks,
the 11 NAS ops and the bilinear resize must agree to rtol = atol = 1e-5
(float32 convolutions summed in different orders by XLA and oneDNN).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.core.layers import conv_bn_init, conv_bn_apply
from segtpu.core.resize import (_interp_matrix as jax_interp_matrix,
                                resize_bilinear as jax_resize)
from segtpu.ops.layer_factory import OP_NAMES as JAX_OP_NAMES, op_init, op_apply

from segtpu_torch.convert import load_jax_params
from segtpu_torch.core.layers import ConvBN
from segtpu_torch.core.resize import _interp_matrix, resize_bilinear
from segtpu_torch.ops.layer_factory import OP_NAMES, Op

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturb_bn(params, stats, rng):
    """Non-identity BatchNorm: perturb every scale/bias/mean/var leaf."""
    def walk(p, s):
        if isinstance(p, dict):
            if "scale" in p:
                c = p["scale"].shape
                p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                s["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                s["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            for k in p:
                if isinstance(p[k], (dict, list)):
                    walk(p[k], s.get(k, {}))
        elif isinstance(p, list):
            for a, b in zip(p, s):
                walk(a, b)
    walk(params, stats)
    return params, stats


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_nhwc, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("k,stride,dilation,groups,act,cin,cout", [
    (1, 1, 1, 1, "relu", 8, 16),
    (3, 1, 1, 1, "relu6", 6, 8),
    (3, 2, 1, 1, "relu6", 3, 8),      # the nhwc3 stem: symmetric pad 1
    (3, 2, 1, 8, "relu6", 8, 8),      # stride-2 depthwise
    (5, 1, 6, 8, "relu", 8, 8),       # dilated depthwise
    (3, 1, 3, 1, "none", 8, 4),
])
def test_conv_bn_act_matches_jax(k, stride, dilation, groups, act, cin, cout):
    rng = np.random.default_rng(0)
    p, s = _np_tree(conv_bn_init(jax.random.PRNGKey(1), k, k, cin, cout,
                                 groups=groups))
    p, s = perturb_bn(p, s, rng)
    x = rng.standard_normal((2, 18, 20, cin)).astype(np.float32)
    want, _ = conv_bn_apply(p, s, jnp.asarray(x), stride=stride,
                            dilation=dilation, groups=groups, act=act)
    m = ConvBN(cin, cout, k, stride=stride, dilation=dilation, groups=groups,
               act=act, generator=torch.Generator().manual_seed(0))
    load_jax_params(m, p, s)
    got = m(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_op_names_match():
    assert OP_NAMES == JAX_OP_NAMES


@pytest.mark.parametrize("name", OP_NAMES)
def test_op_matches_jax(name):
    c = 8
    rng = np.random.default_rng(1)
    p, s = _np_tree(op_init(name, jax.random.PRNGKey(2), c))
    p, s = perturb_bn(p, s, rng)
    x = rng.standard_normal((2, 16, 16, c)).astype(np.float32)
    want, _ = op_apply(name, p, s, jnp.asarray(x))
    op = Op(name, c, generator=torch.Generator().manual_seed(0))
    load_jax_params(op, p, s)
    got = op(_nchw(x))
    assert got.shape == (2, c, 16, 16)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_in,n_out", [(16, 64), (7, 29), (12, 12), (64, 16)])
@pytest.mark.parametrize("align_corners", [True, False])
def test_interp_matrix_identical(n_in, n_out, align_corners):
    np.testing.assert_array_equal(_interp_matrix(n_in, n_out, align_corners),
                                  jax_interp_matrix(n_in, n_out, align_corners))


@pytest.mark.parametrize("in_hw,out_hw", [((8, 16), (32, 64)),
                                          ((5, 7), (18, 30)),
                                          ((8, 8), (8, 8))])
@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_bilinear_matches_jax(in_hw, out_hw, align_corners):
    x = np.random.default_rng(2).standard_normal((2, *in_hw, 5)).astype(
        np.float32)
    want = jax_resize(jnp.asarray(x), out_hw, align_corners=align_corners)
    got = resize_bilinear(_nchw(x), out_hw, align_corners=align_corners)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
