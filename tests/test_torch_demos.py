"""The demo models and the MNIST IDX files of the port against the JAX package.

The five demo trainings of tests/test_training.py:44-100 run on the port
(device="cpu") with the same data, epochs and Adam settings and must learn as
the JAX ones do. Each demo's forward, on params drawn by the JAX initialiser
and carried over with demo_params_from_jax, agrees with the JAX forward within
1e-5 * max|out| (f32 on both sides; sums in another order). The initialisers
draw byte-identical params from one seed, and write_synthetic_mnist writes
the same bytes as the JAX package's. The nn.layers functions the demos and
the graph tier use (conv2d at "VALID" and "SAME", max_pool2d, batchnorm2d in
train mode, silu, gelu) agree with the JAX ones within the same bound.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zgml_tpu.data import write_synthetic_mnist as jax_write_mnist
from zgml_tpu.models import demos as jdemos

from zgml_tpu_torch.data.mnist import load_mnist, write_synthetic_mnist
from zgml_tpu_torch.models import demos
from zgml_tpu_torch.models.demos import demo_params_from_jax
from zgml_tpu_torch.nn.train import train_supervised, train_unsupervised
from zgml_tpu_torch.optim.adam import AdamConfig
from zgml_tpu_torch.utils.tree import paths

torch.set_num_threads(1)
FWD_RTOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_linear_regression_learns():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 1)).astype(np.float32)
    y = 2.5 * x + 0.7
    p = demos.linear_regression_init(device="cpu")
    p, losses = train_supervised(p, demos.linear_regression_loss, x, y, epochs=40,
                                 batch_size=64, adam=AdamConfig(lr=0.05))
    assert losses[-1] < 0.01
    assert abs(float(p["w"][0, 0]) - 2.5) < 0.1
    assert abs(float(p["b"][0]) - 0.7) < 0.1


def test_xor_mlp_learns():
    p, _ = demos.train_xor(epochs=400, device="cpu")
    x = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=torch.float32)
    pred = demos.xor_mlp_forward(p, x).numpy()[:, 0]
    assert (pred.round() == np.asarray([0, 1, 1, 0])).all(), pred


def _blobs():
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((3, 8)) * 4
    y = rng.integers(0, 3, 512)
    x = (centers[y] + rng.standard_normal((512, 8))).astype(np.float32)
    return x, y


def test_mlp_classifier_learns_blobs():
    x, y = _blobs()
    p = demos.mlp_classifier_init(8, 32, 3, device="cpu")
    p, _ = train_supervised(p, demos.mlp_classifier_loss, x, y.astype(np.int32), epochs=20,
                            batch_size=64, adam=AdamConfig(lr=0.01))
    logits = demos.mlp_classifier_forward(p, torch.from_numpy(x)).numpy()
    acc = float(np.mean(np.argmax(logits, -1) == y))
    assert acc > 0.9, acc


def test_conv_classifier_on_synthetic_mnist(tmp_path):
    write_synthetic_mnist(tmp_path, n_train=256, n_test=64)
    xi, yi = load_mnist(tmp_path, "train")
    xt, yt = load_mnist(tmp_path, "test")
    p = demos.conv_classifier_init(device="cpu")
    p, _ = train_supervised(p, demos.conv_classifier_loss, xi, yi, epochs=6, batch_size=32,
                            adam=AdamConfig(lr=3e-3))
    logits = demos.conv_classifier_forward(p, torch.from_numpy(xt)).numpy()
    acc = float(np.mean(np.argmax(logits, -1) == yt))
    assert acc > 0.8, acc


def _ae_data():
    rng = np.random.default_rng(2)
    basis = rng.standard_normal((4, 64)).astype(np.float32)
    codes = rng.standard_normal((256, 4)).astype(np.float32)
    return np.asarray(jax.nn.sigmoid(jnp.asarray(codes @ basis)))


def test_autoencoder_reconstructs():
    x = _ae_data()
    p = demos.autoencoder_init(64, 16, device="cpu")
    p, losses = train_unsupervised(p, demos.autoencoder_loss, x, epochs=30, batch_size=64,
                                   adam=AdamConfig(lr=3e-3))
    assert losses[-1] < losses[0] * 0.5


def _xor_x():
    return np.asarray([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)


# (name, JAX params, port init on the CPU, forward's input)
def _cases():
    rng = np.random.default_rng(9)
    poly = {"coef": rng.standard_normal(4).astype(np.float32)}
    lin = {"w": rng.standard_normal((1, 1)).astype(np.float32),
           "b": rng.standard_normal(1).astype(np.float32)}
    return {
        "linear_regression": (lin, None, rng.standard_normal((16, 1)).astype(np.float32)),
        "poly": (poly, None, rng.standard_normal((16, 1)).astype(np.float32)),
        "xor_mlp": (jdemos.xor_mlp_init(seed=3), lambda: demos.xor_mlp_init(seed=3, device="cpu"),
                    _xor_x()),
        "mlp_classifier": (jdemos.mlp_classifier_init(8, 32, 3, seed=4),
                           lambda: demos.mlp_classifier_init(8, 32, 3, seed=4, device="cpu"),
                           _blobs()[0][:64]),
        "conv_classifier": (jdemos.conv_classifier_init(seed=5, batchnorm=True),
                            lambda: demos.conv_classifier_init(seed=5, batchnorm=True,
                                                               device="cpu"),
                            rng.random((6, 28, 28)).astype(np.float32)),
        "autoencoder": (jdemos.autoencoder_init(64, 16, seed=6),
                        lambda: demos.autoencoder_init(64, 16, seed=6, device="cpu"),
                        _ae_data()[:32]),
    }


@pytest.mark.parametrize("name", ["linear_regression", "poly", "xor_mlp", "mlp_classifier",
                                  "conv_classifier", "autoencoder"])
def test_forward_matches_jax(name):
    jparams, port_init, x = _cases()[name]
    jfwd = getattr(jdemos, f"{name}_forward")
    fwd = getattr(demos, f"{name}_forward")
    want = np.asarray(jfwd(jax.tree.map(jnp.asarray, jparams), jnp.asarray(x)))
    p = demo_params_from_jax(_np_tree(jparams), device="cpu")
    with torch.no_grad():
        got = fwd(p, torch.tensor(x)).numpy()
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - want)))
    assert err <= FWD_RTOL * float(np.max(np.abs(want))), err
    if port_init is not None:        # the port's own initialiser draws the same bytes
        mine = paths(port_init())
        theirs = paths(_np_tree(jparams))
        assert [n for n, _ in mine] == [n for n, _ in theirs]
        for (n, a), (_, b) in zip(mine, theirs):
            assert a.numpy().tobytes() == np.asarray(b).tobytes(), n


def _layer_case(name, rng):
    """(JAX output, port output) of one nn.layers function on shared numpy
    inputs; conv2d takes NHWC / HWIO, "SAME" at stride 2 on an odd size pads
    unevenly (XLA puts the extra row last)."""
    from zgml_tpu.nn import layers as jl
    from zgml_tpu_torch.nn import layers as pl
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if name.startswith("conv2d"):
        _, padding, stride = name.split("_")
        return (jl.conv2d(jnp.asarray(x), jnp.asarray(w), int(stride), padding),
                pl.conv2d(xt, wt, int(stride), padding))
    if name.startswith("max_pool2d"):
        window, stride = (int(v) for v in name.split("_")[-2:])
        return jl.max_pool2d(jnp.asarray(x), window, stride), pl.max_pool2d(xt, window, stride)
    if name == "batchnorm2d_train":
        p = {"gamma": rng.standard_normal(3).astype(np.float32),
             "beta": rng.standard_normal(3).astype(np.float32),
             "mean": np.zeros(3, np.float32), "var": np.ones(3, np.float32)}
        jy, jp = jl.batchnorm2d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), train=True)
        py, pp = pl.batchnorm2d({k: torch.from_numpy(v) for k, v in p.items()}, xt, train=True)
        return ([jy, jp["mean"], jp["var"]], [py, pp["mean"], pp["var"]])
    if name == "causal_mask":
        return jl.causal_mask(5), pl.causal_mask(5)
    if name == "linear_init":
        return (jl.linear_init(np.random.default_rng(4), 7, 5)["w"],
                pl.linear_init(np.random.default_rng(4), 7, 5, device="cpu")["w"])
    fn = name                                   # silu, gelu: elementwise
    return getattr(jl, fn)(jnp.asarray(x)), getattr(pl, fn)(xt)


@pytest.mark.parametrize("name", ["conv2d_VALID_1", "conv2d_SAME_1", "conv2d_SAME_2",
                                  "max_pool2d_2_2", "max_pool2d_3_2", "batchnorm2d_train",
                                  "causal_mask", "linear_init", "silu", "gelu"])
def test_layer_matches_jax(name):
    """Each nn.layers function against the JAX one within 1e-5 * max|out|
    (f32; sums in another order); masks and initial values equal."""
    want, got = _layer_case(name, np.random.default_rng(11))
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if w.dtype == np.bool_ or name == "linear_init":
            assert g.tobytes() == w.tobytes()
        else:
            assert float(np.max(np.abs(g - w))) <= FWD_RTOL * float(np.max(np.abs(w)))


def test_write_synthetic_mnist_matches_jax_bytes(tmp_path):
    write_synthetic_mnist(tmp_path / "port", n_train=64, n_test=16, seed=3)
    jax_write_mnist(tmp_path / "jax", n_train=64, n_test=16, seed=3)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 4
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    xi, yi = load_mnist(tmp_path / "port", "train")
    assert xi.shape == (64, 28, 28) and xi.dtype == np.float32 and yi.dtype == np.int32

