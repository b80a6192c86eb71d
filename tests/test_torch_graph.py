"""The port's graph tier (zgml_tpu_torch/graph) against the JAX package's.

Every test of tests/test_graph.py runs again on the port with device="cpu",
where each fused chain runs K13's plain composition. Then parity with the
JAX ComputeGraph on the same numpy feeds: run, grad and value_and_grad with
fusion on and off within 1e-5 * max|out| (f32 on both sides, sums in another
order; transcendentals from two libraries); the same report() text; to_dot()
equal up to node ids (ids come from a process-wide counter in each package);
and a small graph_ffn (the smoke's FFN graph at d 64, d_ff 176, 16 rows).

The SUB/DIV case: where the chain value is the right operand of a binary
step (y.sub(x.exp())), the port computes the graph's function, which JAX's
fuse=False lowering computes; JAX's fuse=True lowering computes exp(x) - y
there (a reference weak spot, ROADMAP.md), which the last test records.
"""
import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import zgml_tpu.graph as jgraph

from zgml_tpu_torch.graph import ComputeGraph, Op, const, var
from zgml_tpu_torch.graph.graph import topo_order
from zgml_tpu_torch.ops import refs
from zgml_tpu_torch.runtime.profile import global_profile

torch.set_num_threads(1)
RTOL = 1e-5


def _cpu(y, fuse=True):
    return ComputeGraph(y, fuse=fuse, device="cpu")


# -- tests/test_graph.py on the port -----------------------------------------

def test_build_and_shapes():
    x = var("x", (4, 8))
    w = var("w", (8, 16))
    y = x.matmul(w).relu().sum()
    assert y.shape == ()
    order = topo_order([y])
    assert order[-1] is y
    with pytest.raises(ValueError):
        x.matmul(var("bad", (4, 4)))  # inner-dim mismatch at build time
    with pytest.raises(ValueError):
        x.reshape(5, 5)


def test_forward_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((4, 8)).astype(np.float32)
    x, y = var("x", (4, 8)), var("y", (4, 8))
    z = (x * y + x).silu().sum(axis=1)
    out = np.asarray(_cpu(z).run(x=a, y=b))
    t = a * b + a
    want = (t / (1 + np.exp(-t))).sum(1)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_fusion_detects_chain():
    x = var("x", (8, 8))
    y = x.neg().exp().scale(2.0).relu()   # 4-op chain
    g = _cpu(y)
    assert g.fusion is not None
    assert len(g.fusion.chains) == 1
    assert len(g.fusion.chains[0].nodes) == 4


def test_fusion_on_off_equivalence():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 32)).astype(np.float32)
    b = rng.standard_normal((16, 32)).astype(np.float32)
    x, y = var("x", (16, 32)), var("y", (16, 32))
    z = (x.exp().mul(y).add(x).tanh()).sum()
    out_f = np.asarray(_cpu(z, fuse=True).run(x=a, y=b))
    out_n = np.asarray(_cpu(z, fuse=False).run(x=a, y=b))
    np.testing.assert_allclose(out_f, out_n, rtol=1e-4, atol=1e-4)


def test_multi_consumer_blocks_fusion():
    x = var("x", (4, 4))
    e = x.exp()
    y = e.mul(e.neg())   # e has two consumers -> not a simple chain head
    g = _cpu(y)
    for c in (g.fusion.chains if g.fusion else []):
        assert e not in c.nodes[:-1]


def test_grad_simple():
    x = var("x", (5,))
    y = x.sqr().scale(3.0).sum()
    a = np.arange(5, dtype=np.float32)
    grads = _cpu(y).grad(["x"])(x=a)
    np.testing.assert_allclose(np.asarray(grads["x"]), 6 * a, rtol=1e-5)


def test_grad_matmul_and_softmax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    w0 = rng.standard_normal((4, 2)).astype(np.float32)
    tgt = np.asarray([1, 0, 1], np.int32)
    x, w, t = var("x", (3, 4)), var("w", (4, 2)), var("t", (3,), np.int32)
    loss = x.matmul(w).cross_entropy(t)
    g = _cpu(loss)
    val, grads = g.value_and_grad(["w"])(x=a, w=w0, t=tgt)
    eps = 1e-3
    gw = np.asarray(grads["w"])
    fn = g.compile()
    for i in (0, 1):
        for j in (0, 1):
            wp = w0.copy(); wp[i, j] += eps    # noqa: E702
            wm = w0.copy(); wm[i, j] -= eps    # noqa: E702
            fd = (float(fn(a, wp, tgt)) - float(fn(a, wm, tgt))) / (2 * eps)
            assert abs(fd - gw[i, j]) < 1e-2, (i, j, fd, gw[i, j])


def test_attention_node_and_grad():
    rng = np.random.default_rng(3)
    qv, kv, vv = (rng.standard_normal((1, 4, 8)).astype(np.float32) for _ in range(3))
    q, k, v = var("q", (1, 4, 8)), var("k", (1, 4, 8)), var("v", (1, 4, 8))
    y = q.attention(k, v, causal=True).sum()
    grads = _cpu(y).grad(["q", "k", "v"])(q=qv, k=kv, v=vv)
    for key in ("q", "k", "v"):
        assert np.isfinite(np.asarray(grads[key])).all()


def test_composites_match_refs():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 10)).astype(np.float32)
    gm = rng.standard_normal(10).astype(np.float32)
    x, gvar = var("x", (6, 10)), var("g", (10,))
    out = _cpu(x.rms_norm(gvar, 1e-5)).run(x=a, g=gm)
    want = refs.rmsnorm(torch.from_numpy(a), torch.from_numpy(gm), 1e-5)
    np.testing.assert_allclose(np.asarray(out), want.numpy(), rtol=1e-5, atol=1e-5)


def test_report_and_dot():
    x = var("x", (4, 4))
    y = x.exp().relu().sum()
    g = _cpu(y)
    rep = g.report()
    assert "nodes" in rep and "chains" in rep
    dot = g.to_dot()
    assert dot.startswith("digraph") and "exp" in dot


def test_conv_and_pool_forward_and_grad():
    rng = np.random.default_rng(5)
    xv = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    wv = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    x, w = var("x", (2, 8, 8, 3)), var("w", (3, 3, 3, 4))
    y = x.conv2d(w).relu().max_pool2d(2).sum()
    g = _cpu(y)
    val = float(g.run(x=xv, w=wv))
    from zgml_tpu.nn.layers import conv2d, max_pool2d
    want = float(jnp.sum(max_pool2d(jax.nn.relu(conv2d(jnp.asarray(xv), jnp.asarray(wv))), 2)))
    assert abs(val - want) < 1e-2 * abs(want)
    grads = g.grad(["w"])(x=xv, w=wv)
    assert grads["w"].shape == (3, 3, 3, 4)
    assert np.isfinite(np.asarray(grads["w"])).all()
    with pytest.raises(ValueError):
        x.conv2d(var("bad", (3, 3, 5, 4)))


def test_rope_slice_assign_scatter_add():
    rng = np.random.default_rng(7)
    xh = rng.standard_normal((2, 8, 16)).astype(np.float32)
    cos_t, sin_t = refs.rope_cos_sin(torch.arange(8), 16)
    x = var("x", (2, 8, 16))
    cos, sin = var("cos", (8, 8)), var("sin", (8, 8))
    got = np.asarray(_cpu(x.rope(cos, sin)).run(x=xh, cos=cos_t.numpy(), sin=sin_t.numpy()))
    want = refs.rope_apply(torch.from_numpy(xh), cos_t, sin_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        x.rope(var("c2", (8, 4)), sin)

    dst, src = var("dst", (4, 6)), var("src", (2, 3))
    d = np.zeros((4, 6), np.float32)
    out = np.asarray(_cpu(dst.slice_assign(src, (1, 2))).run(dst=d, src=np.ones((2, 3),
                                                                            np.float32)))
    want2 = d.copy()
    want2[1:3, 2:5] = 1.0
    np.testing.assert_array_equal(out, want2)
    with pytest.raises(ValueError):
        dst.slice_assign(src, (3, 2))

    tbl, upd, idx = var("tbl", (5, 4)), var("upd", (3, 4)), var("idx", (3,))
    u = rng.standard_normal((3, 4)).astype(np.float32)
    ii = np.array([1, 3, 1], np.int32)
    out3 = np.asarray(_cpu(tbl.scatter_add_rows(upd, idx)).run(
        tbl=np.zeros((5, 4), np.float32), upd=u, idx=ii))
    want3 = np.zeros((5, 4), np.float32)
    np.add.at(want3, ii, u)
    np.testing.assert_allclose(out3, want3, rtol=1e-6, atol=1e-6)


def test_graph_kv_cache_decode():
    h, s, d, pos = 2, 8, 16, 5
    rng = np.random.default_rng(8)
    ck, cv = (rng.standard_normal((h, s, d)).astype(np.float32) for _ in range(2))
    qn, kn, vn = (rng.standard_normal((h, 1, d)).astype(np.float32) for _ in range(3))
    cache_k, cache_v = var("ck", (h, s, d)), var("cv", (h, s, d))
    q = var("q", (h, 1, d))
    k_new, v_new = var("kn", (h, 1, d)), var("vn", (h, 1, d))
    ck2 = cache_k.slice_assign(k_new, (0, pos, 0))
    cv2 = cache_v.slice_assign(v_new, (0, pos, 0))
    live_k = ck2.slice((0, 0, 0), (h, pos + 1, d))
    live_v = cv2.slice((0, 0, 0), (h, pos + 1, d))
    got = np.asarray(_cpu(q.attention(live_k, live_v, causal=False)).run(
        ck=ck, cv=cv, q=qn, kn=kn, vn=vn))
    ck_ref, cv_ref = ck.copy(), cv.copy()
    ck_ref[:, pos] = kn[:, 0]
    cv_ref[:, pos] = vn[:, 0]
    want = refs.attention_ref(torch.from_numpy(qn), torch.from_numpy(ck_ref[:, :pos + 1]),
                              torch.from_numpy(cv_ref[:, :pos + 1]), None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_every_op_has_a_lowering_rule():
    import inspect
    from zgml_tpu_torch.graph import lower
    src = inspect.getsource(lower)
    for op in Op:
        assert f"Op.{op.name}" in src or op in (Op.VAR, Op.CONST), f"no lowering for {op}"


def test_env_reads_centralized():
    """Every ZGML_TPU_* variable is read in zgml_tpu_torch/config.py and
    nowhere else in the port."""
    import zgml_tpu_torch
    root = pathlib.Path(zgml_tpu_torch.__file__).parent
    offenders = []
    for p in root.rglob("*.py"):
        rel = p.relative_to(root).as_posix()
        if rel == "config.py":
            continue
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if re.search(r"os\.(environ(\.get)?\s*[\[(]|getenv\s*\()\s*['\"]ZGML_TPU", line):
                offenders.append(f"{rel}:{i}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


# -- parity with the JAX ComputeGraph ----------------------------------------

def _both(build):
    """build(var, const) -> outputs, once with each package's constructors."""
    return build(jgraph.var, jgraph.const), build(var, const)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


def _g_chain(v, c):
    x, y = v("x", (16, 33)), v("y", (33,))
    return (x.exp().mul(y).add(x).tanh().scale(0.5).add_scalar(0.25).sqr()).mean()


def _g_mlp(v, c):
    x, w1, w2 = v("x", (12, 10)), v("w1", (10, 24)), v("w2", (24, 6))
    t = v("t", (12,), np.int32)
    m = x.matmul(w1)
    h = m.gelu().mul(m).relu().maximum(m).scale(0.5)
    return h.matmul(w2).log_softmax().pick_rows(t).neg().mean()


def _g_norm_attn(v, c):
    x, g, b = v("x", (2, 6, 16)), v("g", (16,)), v("b", (16,))
    h = x.layer_norm(g, b).rms_norm(g)
    att = h.attention(h.scale(0.5), h, causal=True, scale=0.3)
    return att.softmax().add(c(np.float32(0.1))).log().sum(axis=(1, 2)).maximum(
        c(np.zeros(2, np.float32))).sum()


GRAPHS = {"chain": (_g_chain, ["x", "y"]), "mlp": (_g_mlp, ["w1", "w2"]),
          "norm_attn": (_g_norm_attn, ["x", "g", "b"])}


def _feeds(name):
    rng = np.random.default_rng(len(name))
    if name == "chain":
        return {"x": rng.standard_normal((16, 33)).astype(np.float32),
                "y": rng.standard_normal(33).astype(np.float32)}
    if name == "mlp":
        return {"x": rng.standard_normal((12, 10)).astype(np.float32),
                "w1": (rng.standard_normal((10, 24)) * 0.3).astype(np.float32),
                "w2": (rng.standard_normal((24, 6)) * 0.3).astype(np.float32),
                "t": rng.integers(0, 6, 12).astype(np.int32)}
    return {"x": rng.standard_normal((2, 6, 16)).astype(np.float32),
            "g": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(16)).astype(np.float32)}


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_run_and_grads_match_jax(name, fuse):
    build, wrt = GRAPHS[name]
    jy, py = _both(build)
    feeds = _feeds(name)
    jg, pg = jgraph.ComputeGraph(jy, fuse=fuse), _cpu(py, fuse=fuse)
    _close(pg.run(**feeds), jg.run(**feeds))
    jval, jgr = jg.value_and_grad(wrt)(**feeds)
    pval, pgr = pg.value_and_grad(wrt)(**feeds)
    _close(pval, jval)
    assert sorted(pgr) == sorted(jgr) == sorted(wrt)
    for n in wrt:
        _close(pgr[n], jgr[n])
    g_only = pg.grad(wrt)(**feeds)
    for n in wrt:
        np.testing.assert_array_equal(np.asarray(g_only[n]), np.asarray(pgr[n]))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_report_and_dot_match_jax(name):
    jy, py = _both(GRAPHS[name][0])
    jg, pg = jgraph.ComputeGraph(jy), _cpu(py)

    def renumber(text, order):
        ids = {n.id: i for i, n in enumerate(order)}
        return re.sub(r"#(\d+)|n(\d+)\b",
                      lambda m: (f"#{ids[int(m.group(1))]}" if m.group(1)
                                 else f"n{ids[int(m.group(2))]}"), text)
    assert renumber(pg.report(), pg.order) == renumber(jg.report(), jg.order)
    assert renumber(pg.to_dot(), pg.order) == renumber(jg.to_dot(), jg.order)
    assert [[n.op.value for n in c.nodes] for c in pg.fusion.chains] == \
        [[n.op.value for n in c.nodes] for c in jg.fusion.chains]


def _ffn_graph(v, d, f, rows):
    x, g = v("x", (rows, d)), v("g", (d,))
    wg, wu, wd = v("w_gate", (d, f)), v("w_up", (d, f)), v("w_down", (f, d))
    h = x.rms_norm(g)
    y = h.matmul(wg).silu().mul(h.matmul(wu)).matmul(wd).add(x)
    return y.sqr().mean()


def test_graph_ffn_matches_jax():
    """The smoke's graph_ffn at d 64, d_ff 176, 16 rows: the two chains
    silu -> mul and add -> sqr, each one K13 launch (its plain composition on
    the CPU, counted under ref), and run / value_and_grad, fused and not,
    within 1e-5 of JAX's fuse=False graph. The side input of silu -> mul
    (h @ w_up) comes after the chain's head in topo order, so JAX's fuse=True
    graph raises KeyError here (test_chain_side_input_after_its_head)."""
    d, f, rows = 64, 176, 16
    rng = np.random.default_rng(0)
    feeds = {"x": (rng.standard_normal((rows, d)) * 0.02).astype(np.float32),
             "g": (1 + 0.02 * rng.standard_normal(d)).astype(np.float32),
             "w_gate": (rng.standard_normal((d, f)) * 0.02).astype(np.float32),
             "w_up": (rng.standard_normal((d, f)) * 0.02).astype(np.float32),
             "w_down": (rng.standard_normal((f, d)) * 0.02).astype(np.float32)}
    wrt = ["g", "w_gate", "w_up", "w_down"]
    jg = jgraph.ComputeGraph(_ffn_graph(jgraph.var, d, f, rows), fuse=False)
    jval, jgr = jg.value_and_grad(wrt)(**feeds)
    py = _ffn_graph(var, d, f, rows)
    for fuse in (True, False):
        pg = _cpu(py, fuse=fuse)
        global_profile.reset()
        _close(pg.run(**feeds), jval)
        pval, pgr = pg.value_and_grad(wrt)(**feeds)
        _close(pval, jval)
        for n in wrt:
            _close(pgr[n], jgr[n])
        tiers = global_profile.tier_summary()
        if fuse:
            assert [[n.op.value for n in c.nodes] for c in pg.fusion.chains] == \
                [["silu", "mul"], ["add", "sqr"]]
            assert tiers["fused_chain"] == {"ref": 4}            # 2 per forward
            assert tiers["fused_chain_bwd"] == {"torch": 2}
        else:
            assert "fused_chain" not in tiers
    with pytest.raises(KeyError):
        jgraph.ComputeGraph(_ffn_graph(jgraph.var, d, f, rows), fuse=True).run(**feeds)


def _sub_div(v):
    x, y = v("x", (4, 8)), v("y", (4, 8))
    return [y.sub(x.exp()), y.div(x.exp())]


def _sub_div_feeds():
    return {"x": np.linspace(-1, 1, 32, dtype=np.float32).reshape(4, 8),
            "y": np.full((4, 8), 3.0, np.float32)}


def test_chain_value_on_the_right_is_the_graph_function():
    """y - exp(x) and y / exp(x) fuse to exp -> sub and exp -> div with the
    chain value as the right operand: fused, the port gives the graph's
    function, JAX's fuse=False value (and numpy's)."""
    feeds = _sub_div_feeds()
    pg = _cpu(_sub_div(var))
    assert [[n.op.value for n in c.nodes] for c in pg.fusion.chains] == [["exp", "sub"],
                                                                         ["exp", "div"]]
    got = pg.run(**feeds)
    want_j = jgraph.ComputeGraph(_sub_div(jgraph.var), fuse=False).run(**feeds)
    want_np = (feeds["y"] - np.exp(feeds["x"]), feeds["y"] / np.exp(feeds["x"]))
    for a, b, c in zip(got, want_j, want_np):
        _close(a, b)
        _close(a, c)
    assert abs(float(got[0][0, 0]) - 2.632) < 1e-3         # 3 - e^-1
    assert abs(float(got[1][0, 0]) - 8.1548) < 1e-3        # 3 / e^-1


def test_jax_fused_chain_reverses_the_right_operand():
    """The reference weak spot the port does not copy: JAX's fuse=True
    lowering computes exp(x) - y and exp(x) / y where the graph says
    y - exp(x) and y / exp(x) (zgml_tpu/graph/graph.py:116-124 with
    ops/elementwise.py:96-101). At x = linspace(-1, 1), y = 3, element [0, 0]
    is -2.632 fused and +2.632 unfused, 0.1226 against 8.1548. If this test
    fails, the JAX package has changed and ROADMAP.md's record is stale."""
    feeds = _sub_div_feeds()
    fused = jgraph.ComputeGraph(_sub_div(jgraph.var), fuse=True).run(**feeds)
    plain = jgraph.ComputeGraph(_sub_div(jgraph.var), fuse=False).run(**feeds)
    assert abs(float(fused[0][0, 0]) + 2.632) < 1e-3 and abs(float(plain[0][0, 0]) - 2.632) < 1e-3
    assert abs(float(fused[1][0, 0]) - 0.1226) < 1e-3 and abs(float(plain[1][0, 0]) - 8.1548) < 1e-3
    port = _cpu(_sub_div(var)).run(**feeds)
    _close(port[0], plain[0])
    _close(port[1], plain[1])


def test_chain_longer_than_one_launch():
    """A 36-step chain with 18 side inputs (K13 takes 16 steps and 8 side
    inputs a launch) runs as consecutive launches: 16 + 16 + 4 steps here,
    each launch's binary steps within 8 sides. Bit-equal to fuse=False (the
    same torch ops in the same order) and to the JAX lowering within 1e-5."""
    rng = np.random.default_rng(13)
    feeds = {k: rng.uniform(0.5, 1.5, (6, 10)).astype(np.float32) for k in ("x", "y")}

    def build(v):
        x, y = v("x", (6, 10)), v("y", (6, 10))
        h = x
        for _ in range(18):
            h = h.tanh().mul(y)
        return h
    pg = _cpu(build(var))
    assert [len(c.nodes) for c in pg.fusion.chains] == [36]
    global_profile.reset()
    got = pg.run(**feeds)
    assert global_profile.tier_summary() == {"fused_chain": {"ref": 3}}
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(_cpu(build(var), fuse=False).run(**feeds)))
    _close(got, jgraph.ComputeGraph(build(jgraph.var), fuse=False).run(**feeds))


def test_kernels_ref_runs_chains_node_by_node(monkeypatch):
    """ZGML_TPU_KERNELS=ref turns the graph tier's fused chain off, as the
    JAX package's use_pallas() with no name (graph.py:129-130): the 36-step
    chain of test_chain_longer_than_one_launch runs node by node, with no
    K13 placement, bit-equal to fuse=False; the same JAX graph under the
    same switch within 1e-5. Read at each run: unset, the chain is back."""
    rng = np.random.default_rng(13)
    feeds = {k: rng.uniform(0.5, 1.5, (6, 10)).astype(np.float32) for k in ("x", "y")}

    def build(v):
        x, y = v("x", (6, 10)), v("y", (6, 10))
        h = x
        for _ in range(18):
            h = h.tanh().mul(y)
        return h
    pg = _cpu(build(var))
    monkeypatch.setenv("ZGML_TPU_KERNELS", "ref")
    global_profile.reset()
    got = pg.run(**feeds)
    assert "fused_chain" not in global_profile.tier_summary()
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(_cpu(build(var), fuse=False).run(**feeds)))
    _close(got, jgraph.ComputeGraph(build(jgraph.var), fuse=True).run(**feeds))
    monkeypatch.delenv("ZGML_TPU_KERNELS")
    global_profile.reset()
    pg.run(**feeds)
    assert global_profile.tier_summary() == {"fused_chain": {"ref": 3}}


def test_chain_side_input_after_its_head():
    """x.exp().mul(x.sigmoid()) fuses to exp -> mul, whose side input
    (sigmoid) comes after the chain's head in topo order. The port emits a
    chain at its output node and computes the graph's function; the JAX
    package emits it at its head and raises KeyError (a reference weak spot,
    ROADMAP.md). If the JAX call stops raising, the record is stale."""
    rng = np.random.default_rng(12)
    feeds = {"x": rng.standard_normal((8, 24)).astype(np.float32)}

    def build(v):
        x = v("x", (8, 24))
        return x.exp().mul(x.sigmoid())
    pg = _cpu(build(var))
    assert [[n.op.value for n in c.nodes] for c in pg.fusion.chains] == [["exp", "mul"]]
    want = jgraph.ComputeGraph(build(jgraph.var), fuse=False).run(**feeds)
    _close(pg.run(**feeds), want)
    np.testing.assert_array_equal(np.asarray(pg.run(**feeds)),
                                  np.asarray(_cpu(build(var), fuse=False).run(**feeds)))
    with pytest.raises(KeyError):
        jgraph.ComputeGraph(build(jgraph.var), fuse=True).run(**feeds)
