"""Guards of the port: no JAX, no fallback off the supported devices, a clear
build error without nvcc, wrappers that refuse what their kernel does not take."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from zgml_tpu_torch.ops import build, dispatch
from zgml_tpu_torch.ops.attention import (decode_attention_cuda, decode_attention_q8_cuda,
                                          flash_attention_cuda, flash_attention_q8_cuda)
from zgml_tpu_torch.ops.ffn import fused_ffn_norm_cuda
from zgml_tpu_torch.ops.layerkernel import attn_block_cuda
from zgml_tpu_torch.ops.qmatmul import (greedy_cuda, qmatmul_cuda, qmatmul_i8_cuda,
                                        quantize_act_cuda)
from zgml_tpu_torch.quant.packed import PackedWeight

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import zgml_tpu_torch
names = [m.name for m in pkgutil.walk_packages(zgml_tpu_torch.__path__, "zgml_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "zgml_tpu.")) or m == "zgml_tpu")
print(len(names), bad, names)
assert not bad, bad
"""


def test_port_imports_no_jax():
    """Every module of the port imports (the GPT-2 and Whisper modules and
    their loaders, the native host codecs, the packed checkpoint, the
    roofline and the conformance sweep among them) without jax or
    zgml_tpu."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={"PYTHONPATH": str(REPO),
                                                       "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20
    for name in ("models.gpt", "models.whisper", "data.audio", "io.hf_loaders", "native",
                 "io.packed_ckpt", "runtime.roofline", "runtime.conformance"):
        assert f"zgml_tpu_torch.{name}" in proc.stdout, name


def _pw(device):
    return PackedWeight(8, 32, torch.zeros(8, 16, dtype=torch.uint8, device=device),
                        torch.zeros(8, 1, dtype=torch.float16, device=device))


def test_dispatch_refuses_meta_device():
    x = torch.zeros(2, 32, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        dispatch.qmatmul(x, _pw("meta"))
    q = torch.zeros(1, 2, 4, 16, device="meta")
    kv = torch.zeros(1, 1, 8, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        dispatch.flash_attention(q, kv, kv, kv_len=4)
    with pytest.raises(NotImplementedError):
        dispatch.decode_attention(q[:, :, :1], kv, kv, 4)
    with pytest.raises(NotImplementedError):
        dispatch.rmsnorm(x, torch.ones(32, device="meta"))


def test_dispatch_refuses_mixed_devices():
    with pytest.raises(ValueError):
        dispatch.qmatmul(torch.zeros(2, 32), _pw("meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("ZGML_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists()


def test_build_names_library_by_source_hash(monkeypatch, tmp_path):
    monkeypatch.setenv("ZGML_TPU_TORCH_BUILD_DIR", str(tmp_path))
    p = build.library_path()
    assert p.parent == tmp_path and p.name.startswith("libzgml_kernels_")
    assert all((build.CSRC / s).is_file() for s in build.SOURCES + build.HEADERS)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A launcher never runs the plain version: off the card it raises."""
    with pytest.raises(ValueError, match="CUDA"):
        qmatmul_cuda(torch.zeros(1, 32), _pw("cpu"))
    q = torch.zeros(1, 2, 4, 16)
    kv = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, kv, kv, 4)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q[:, :, :1], kv, kv, 4)


def test_decode_tier_wrappers_refuse_cpu_tensors():
    """K1, K5, K6d and K7 launchers raise off the card, as K2-K4's do."""
    x = torch.zeros(1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        qmatmul_i8_cuda(x, _pw("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        greedy_cuda(x, _pw("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        quantize_act_cuda(x)
    gu = PackedWeight(64, 32, torch.zeros(64, 16, dtype=torch.uint8),
                      torch.zeros(64, 1, dtype=torch.float16))
    wd = PackedWeight(32, 32, torch.zeros(32, 16, dtype=torch.uint8),
                      torch.zeros(32, 1, dtype=torch.float16))
    with pytest.raises(ValueError, match="CUDA"):
        fused_ffn_norm_cuda(x, torch.ones(32), gu, wd, 1e-5)
    cache = torch.zeros(1, 1, 1, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block_cuda(x.reshape(1, 1, 32), torch.ones(32), _pw_n(96), _pw_n(32), cache,
                        cache, 0, torch.zeros(1, dtype=torch.int32), torch.ones(1, 16),
                        torch.zeros(1, 16), 1, 1, 1e-5)


def test_decode_f32_form_takes_f32_and_refuses_cpu_tensors():
    """K4's f32 form: check_qkv takes f32 K / V there (the launch then
    refuses the CPU tensors: the device is checked after the dtypes),
    refuses K and V of two dtypes, and the bf16 form refuses f32 K / V."""
    from zgml_tpu_torch.ops.attention import check_qkv
    q = torch.zeros(1, 4, 1, 64)
    f32, bf = torch.zeros(1, 4, 64, 64), torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="decode_attention_f32: q on cpu.*one CUDA device"):
        decode_attention_cuda(q, f32, f32, 8)
    for k, v in ((f32, bf), (bf, f32)):
        with pytest.raises(ValueError, match="k/v must be torch.float32"):
            check_qkv("decode_attention_f32", q, k, v, 0, 1, kv_dtype=torch.float32)
        with pytest.raises(ValueError, match="k/v must be torch.bfloat16"):
            check_qkv("decode_attention", q, k, v, 0, 1)
    with pytest.raises(ValueError, match="k/v must be torch.bfloat16"):
        decode_attention_cuda(q, bf, f32, 8)
    with pytest.raises(ValueError, match="one CUDA device"):
        check_qkv("decode_attention_f32", q, f32, f32, 0, 1, kv_dtype=torch.float32)


def test_int8_cache_wrappers_refuse_cpu_tensors():
    """K8, K9 and K7's int8-cache mode raise off the card, as the others do,
    and K8 / K9 refuse a bf16 cache handed to them as int8."""
    q = torch.zeros(1, 2, 4, 16)
    kv, sc = torch.zeros(1, 1, 8, 16, dtype=torch.int8), torch.ones(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_q8_cuda(q, kv, sc, kv, sc, 4)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_q8_cuda(q[:, :, :1], kv, sc, kv, sc, 4)
    x = torch.zeros(1, 1, 32)
    cache = (torch.zeros(1, 1, 1, 8, 32, dtype=torch.int8), torch.ones(1, 1, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        attn_block_cuda(x, torch.ones(32), _pw_n(96), _pw_n(32), cache, cache, 0,
                        torch.zeros(1, dtype=torch.int32), torch.ones(1, 16),
                        torch.zeros(1, 16), 1, 1, 1e-5)
    if torch.cuda.is_available():
        bf = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="int8"):
            flash_attention_q8_cuda(q.cuda(), bf, sc.cuda(), bf, sc.cuda(), 4)


def test_f32_cache_wrappers_refuse_cpu_tensors():
    """K3's f32-K/V forms and K7's f32-cache mode raise off the card, as
    the others do."""
    q = torch.zeros(1, 2, 4, 16)
    kv = torch.zeros(1, 1, 8, 16)
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="attention: q on cpu.*one CUDA device"):
            flash_attention_cuda(q, kv, kv, 4, bf16=bf16)
    x = torch.zeros(1, 1, 32)
    cache = torch.zeros(1, 1, 1, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block_cuda(x, torch.ones(32), _pw_n(96), _pw_n(32), cache, cache, 0,
                        torch.zeros(1, dtype=torch.int32), torch.ones(1, 16),
                        torch.zeros(1, 16), 1, 1, 1e-5)


def test_f32_cache_is_routed_to_its_kernels_on_a_card(monkeypatch, tmp_path):
    """With the attention kernels taken as on the card (their wrappers
    swapped for the plain versions, which record the cache dtype they were
    handed), an engine over the f32 cache sends each prefill layer to K3
    over f32 K / V, a batch-1 decode layer to K7 over the f32 cache and a
    batch-2 one to K4's f32 form."""
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.models.llama import LlamaConfig
    from zgml_tpu_torch.ops import attention, layerkernel
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf
    seen = []

    def record(name, plain, cache_arg):
        def fn(*args, **kw):
            seen.append((name, args[cache_arg].dtype))
            kw.pop("ffn", None)
            return plain(*args, **kw)
        return fn
    kernel = dispatch._use_kernel
    monkeypatch.setattr(dispatch, "_use_kernel", lambda op, *t: op in (
        "attention", "decode_attention", "attn_block") or kernel(op, *t))
    monkeypatch.setattr(attention, "flash_attention_cuda",
                        record("flash", attention.flash_attention_ref, 1))
    monkeypatch.setattr(attention, "decode_attention_cuda",
                        record("decode", attention.decode_attention_ref, 1))
    monkeypatch.setattr(layerkernel, "attn_block_cuda",
                        record("attn_block", layerkernel.attn_block_ref, 4))
    for k in ("ZGML_TPU_KERNELS", "ZGML_TPU_KERNELS_DISABLE", "ZGML_TPU_ATTN_BLOCK",
              "ZGML_TPU_LAYER_FFN"):
        monkeypatch.delenv(k, raising=False)
    cfg = LlamaConfig(vocab_size=64, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, n_layers=2,
                      max_seq_len=32)
    path = str(tmp_path / "t.gguf")
    write_synthetic_llama_gguf(path, cfg, seed=3)
    model, gf = load_llama(path, device="cpu")
    gf.close()
    n = cfg.n_layers
    for batch, decode in ((1, "attn_block"), (2, "decode")):
        seen.clear()
        eng = LlamaEngine(model, batch=batch, prefill_chunk=16, cache_dtype="f32")
        logits = eng.prefill(np.zeros((batch, 5), np.int64))
        eng.step(torch.argmax(logits, -1))
        assert seen == [("flash", torch.float32)] * n + [(decode, torch.float32)] * n, seen


def _pw_n(n):
    return PackedWeight(n, 32, torch.zeros(n, 16, dtype=torch.uint8),
                        torch.zeros(n, 1, dtype=torch.float16))


def test_load_llama_defaults_to_the_card(tmp_path):
    """load_llama runs on the card unless asked for the CPU: without a card
    the default-argument call raises an error naming the device instead of
    handing back a CPU model."""
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf
    path = str(tmp_path / "tiny.gguf")
    write_synthetic_llama_gguf(path, TINY_TEST, seed=2)
    if torch.cuda.is_available():
        model, gf = load_llama(path)
        gf.close()
        assert model.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device 'cuda'.*device='cpu'"):
        load_llama(path)


def test_init_params_defaults_to_the_card_and_training_follows_params():
    """init_params builds on the card unless asked for the CPU (without a
    card the default raises, naming the device); train_supervised runs on
    the device of the params it is given."""
    from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_params
    from zgml_tpu_torch.nn.losses import cross_entropy_idx
    from zgml_tpu_torch.nn.train import train_supervised
    cfg = LlamaConfig(vocab_size=16, d_model=32, n_heads=2, n_kv_heads=1, d_ff=32, n_layers=1,
                      max_seq_len=8, tied_lm_head=True)
    if torch.cuda.is_available():
        assert init_params(cfg)["tok_embd"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device 'cuda'.*device='cpu'"):
            init_params(cfg)
    data = torch.arange(32).reshape(4, 8).remainder(16).numpy()

    def loss(p, x, y):
        return cross_entropy_idx(LlamaModel(cfg, p)(x)[:, :-1], y[:, 1:])
    p, losses = train_supervised(init_params(cfg, device="cpu"), loss, data, data, epochs=1,
                                 batch_size=2)
    assert p["tok_embd"].device.type == "cpu" and len(losses) == 1


def test_kernels_without_backward_raise_under_grad():
    """K4, K5, K6's normed form, K7, K8 and K9 have no backward (nor have the
    JAX package's kernels): called with grad enabled on an input that
    requires it they raise, naming the ROADMAP item, and never return a
    result whose gradient would be silently zero. The fused FFN of <= 32
    rows (K6b / K6a's no-norm form) has one (ops/ffn.FusedFFN, as JAX's
    `_ffn_diff`): it gives a gradient."""
    x = torch.zeros(1, 1, 32, requires_grad=True)
    gu, wd = _pw_n(64), PackedWeight(32, 32, torch.zeros(32, 16, dtype=torch.uint8),
                                     torch.zeros(32, 1, dtype=torch.float16))
    q = torch.zeros(1, 2, 1, 16, requires_grad=True)
    kv = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16)
    i8, sc = torch.zeros(1, 1, 8, 16, dtype=torch.int8), torch.ones(1, 1, 8)
    cache = torch.zeros(1, 1, 1, 8, 32, dtype=torch.bfloat16)
    calls = [
        lambda: dispatch.qmatmul_greedy(x, _pw("cpu")),
        lambda: dispatch.fused_ffn_norm(x, torch.ones(32), gu, wd, 1e-5),
        lambda: dispatch.attn_block(x, torch.ones(32), _pw_n(96), _pw_n(32), cache, cache, 0,
                                    torch.zeros(1, dtype=torch.int32), torch.ones(1, 16),
                                    torch.zeros(1, 16), 1, 1, 1e-5),
        lambda: dispatch.decode_attention(q, kv, kv, 4),
        lambda: dispatch.decode_attention_q8(q, i8, sc, i8, sc, 4),
        lambda: dispatch.flash_attention_q8(q, i8, sc, i8, sc, 4),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match=r"no backward.*ROADMAP\.md B\.5"):
            call()
    with torch.no_grad():
        assert dispatch.decode_attention(q, kv, kv, 4).shape == q.shape
    (g,) = torch.autograd.grad(dispatch.fused_ffn(x, gu, wd).sum(), x)
    assert g.shape == x.shape


def test_flash_attention_refuses_kv_row_under_grad():
    """The training flash backward reads k / v rows from 0 (as JAX's): a
    kv_row other than 0 under autograd raises; inference keeps it."""
    q = torch.zeros(1, 2, 4, 16, requires_grad=True)
    kv = torch.zeros(2, 1, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="kv_row"):
        dispatch.flash_attention(q, kv, kv, kv_len=4, kv_row=1)
    with torch.no_grad():
        assert dispatch.flash_attention(q, kv, kv, kv_len=4, kv_row=1).shape == q.shape


def test_training_wrappers_refuse_cpu_tensors():
    """K10f, K10dq, K10dkv and K11 launchers raise off the card."""
    from zgml_tpu_torch.ops.flash_vjp import flash_dkv_cuda, flash_dq_cuda, flash_fwd_lse_cuda
    from zgml_tpu_torch.ops.qmatmul import qmatmul_bwd_cuda
    q = torch.zeros(1, 2, 4, 16)
    kv = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_lse_cuda(q, kv, kv, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_dq_cuda(q, kv, kv, q, q, lse, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_dkv_cuda(q, kv, kv, q, q, lse, 4)
    with pytest.raises(ValueError, match="CUDA"):
        qmatmul_bwd_cuda(torch.zeros(1, 8), _pw("cpu"))


def test_force_ref_is_scoped():
    assert not dispatch._force_ref.get()
    with dispatch.force_ref():
        assert dispatch._force_ref.get()
    assert not dispatch._force_ref.get()


NEW_MODULES = ("zgml_tpu_torch.ops.rmsnorm", "zgml_tpu_torch.ops.elementwise",
               "zgml_tpu_torch.graph", "zgml_tpu_torch.graph.op", "zgml_tpu_torch.graph.tensor",
               "zgml_tpu_torch.graph.fusion", "zgml_tpu_torch.graph.lower",
               "zgml_tpu_torch.graph.graph", "zgml_tpu_torch.nn.layers",
               "zgml_tpu_torch.data.mnist", "zgml_tpu_torch.models.demos")


def test_graph_tier_and_demo_modules_import_no_jax():
    """The graph tier, K12 / K13's modules, nn.layers, data.mnist and the
    demos, each imported alone in a fresh process, pull in neither jax nor
    zgml_tpu."""
    code = ("import importlib, sys\n"
            f"for n in {NEW_MODULES!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'zgml_tpu' or m.startswith('zgml_tpu.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={"PYTHONPATH": str(REPO),
                                                       "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr


def test_graph_and_demos_default_to_the_card():
    """ComputeGraph and the demos' initialisers run on the card unless asked
    for the CPU: without a card the default raises, naming the device."""
    from zgml_tpu_torch.graph import ComputeGraph, var
    from zgml_tpu_torch.models import demos
    y = var("x", (2, 2)).exp()
    inits = (demos.xor_mlp_init, demos.linear_regression_init, demos.poly_init,
             demos.conv_classifier_init, lambda: demos.mlp_classifier_init(2, 4, 2),
             demos.autoencoder_init)
    if torch.cuda.is_available():
        assert ComputeGraph(y).device.type == "cuda"
        from zgml_tpu_torch.utils.tree import paths
        assert all(t.device.type == "cuda" for init in inits for _, t in paths(init()))
        return
    with pytest.raises(RuntimeError, match="device 'cuda'.*device='cpu'"):
        ComputeGraph(y)
    for init in inits:
        with pytest.raises(RuntimeError, match="device 'cuda'.*device='cpu'"):
            init()
    assert ComputeGraph(y, device="cpu").device.type == "cpu"


def test_k12_k13_wrappers_refuse_what_their_kernels_do_not_take():
    """K13 refuses a chain of a dtype it has no form for (float64, on any
    device), a chain whose value would leave x's dtype (as the JAX kernel's
    store does) and, like K12, a tensor off the card (bf16 / f16 / int32
    chains included: they have forms); K12 refuses other dtypes."""
    from zgml_tpu_torch.ops.elementwise import Step, check_dtype, fused_chain_cuda
    from zgml_tpu_torch.ops.rmsnorm import rmsnorm_cuda
    steps = [Step("exp"), Step("mul", side=0)]
    x = torch.zeros(4, 8, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="float32"):
        fused_chain_cuda(x, steps, [x])
    for dt in (torch.bfloat16, torch.float16):
        x = torch.zeros(4, 8, dtype=dt)
        with pytest.raises(ValueError, match="CUDA"):
            fused_chain_cuda(x, steps, [x])
    with pytest.raises(ValueError, match="chain's value"):
        check_dtype(torch.zeros(4, 8), steps, [torch.zeros(8, dtype=torch.float64)])
    with pytest.raises(ValueError, match="CUDA"):
        fused_chain_cuda(torch.zeros(4, 8), steps, [torch.zeros(8)])
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(torch.zeros(2, 8), torch.ones(8))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            rmsnorm_cuda(torch.zeros(2, 8, dtype=torch.float64, device="cuda"),
                         torch.ones(8, device="cuda"))


def test_serving_imports_no_jax_and_runs_where_the_model_is(tmp_path):
    """runtime/serving.py, imported alone in a fresh process, pulls in neither
    jax nor zgml_tpu; a server holds its cache and its generator on its
    model's device: the card for a model loaded with the defaults (whose load
    raises without one), the CPU only for a model built with device="cpu"."""
    code = ("import sys\n"
            "import zgml_tpu_torch.runtime.serving\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'zgml_tpu' or m.startswith('zgml_tpu.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={"PYTHONPATH": str(REPO),
                                                       "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
    from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf
    path = str(tmp_path / "tiny.gguf")
    write_synthetic_llama_gguf(path, TINY_TEST, seed=2)
    model, gf = load_llama(path, device="cpu")
    gf.close()
    serve = ContinuousBatchingEngine(model, max_batch=2)
    assert serve.cache["k"].device.type == serve.generator.device.type == "cpu"
    if torch.cuda.is_available():
        model, gf = load_llama(path)
        gf.close()
        serve = ContinuousBatchingEngine(model, max_batch=2)
        assert serve.cache["k"].device.type == serve.generator.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device 'cuda'.*device='cpu'"):
        load_llama(path)


def test_gpt_whisper_and_audio_default_to_the_card(tmp_path):
    """GPT-2's and Whisper's init_params and HF loaders, and the log-mel
    frontend, run on the card unless asked for the CPU: without a card the
    default-argument call raises naming the device."""
    import numpy as np

    from zgml_tpu_torch.data.audio import log_mel_spectrogram
    from zgml_tpu_torch.io.hf_loaders import load_gpt2_hf, load_whisper_hf
    from zgml_tpu_torch.io.llama_loader import gpt_params_from_jax, whisper_params_from_jax
    from zgml_tpu_torch.models import gpt, whisper
    from zgml_tpu_torch.quant import kv_cache
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    gcfg = gpt.GPTConfig(vocab_size=16, d_model=32, n_heads=2, n_layers=1, max_seq_len=8)
    wcfg = whisper.WhisperConfig(n_mels=8, n_audio_ctx=8, n_audio_state=32, n_audio_heads=2,
                                 n_audio_layers=1, vocab_size=16, n_text_ctx=8,
                                 n_text_state=32, n_text_heads=2, n_text_layers=1)
    path = str(tmp_path / "none.safetensors")
    calls = [lambda: gpt.init_params(gcfg), lambda: whisper.init_params(wcfg),
             lambda: load_gpt2_hf(path, gcfg), lambda: load_whisper_hf(path),
             lambda: log_mel_spectrogram(np.zeros(1600, np.float32)),
             lambda: gpt_params_from_jax({"layers": [{}]}, gcfg),
             lambda: whisper_params_from_jax({"enc_layers": [{}], "dec_layers": [{}]}, wcfg),
             lambda: kv_cache.cache_from_jax({"k": [], "v": []})]
    for call in calls:
        with pytest.raises(RuntimeError, match="device 'cuda'.*device='cpu'"):
            call()


_IMPORT_PARALLEL = """
import sys
import zgml_tpu_torch.parallel, zgml_tpu_torch.parallel.dryrun, zgml_tpu_torch.parallel.world
import zgml_tpu_torch.parallel.ring, zgml_tpu_torch.parallel.cp
import zgml_tpu_torch.runtime.serving
bad = sorted(m for m in sys.modules
             if m in ("jax", "zgml_tpu") or m.startswith(("jax.", "zgml_tpu.")))
assert not bad, bad
"""


def test_parallel_and_mesh_server_import_no_jax():
    """parallel/ and the mesh server import neither jax nor zgml_tpu."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PARALLEL], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={"PYTHONPATH": str(REPO),
                                                       "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr


def test_parallel_defaults_to_the_card(tmp_path):
    """init_distributed, make_mesh and shard_llama_params put a rank on the
    card unless asked for the CPU: without a card they raise naming the
    device, before any process group is joined."""
    import torch.distributed as dist

    from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_params
    from zgml_tpu_torch.parallel import init_distributed, make_mesh, shard_llama_params
    from zgml_tpu_torch.parallel.mesh import Mesh
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="device 'cuda'.*device='cpu'"):
        init_distributed(init_method=(tmp_path / "rdv").as_uri(), rank=0, world_size=1)
    assert not dist.is_initialized()
    cfg = LlamaConfig(vocab_size=16, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, n_layers=1)
    model = LlamaModel(cfg, init_params(cfg, device="cpu"))
    mesh = Mesh({"dp": 1, "tp": 1}, {"dp": 0, "tp": 0}, {}, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="device 'cuda'.*device='cpu'"):
        shard_llama_params(model, mesh, device="cuda")
    dist.init_process_group("gloo", init_method=(tmp_path / "rdv2").as_uri(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="device 'cuda'.*device='cpu'"):
            make_mesh()
        assert make_mesh(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_nccl_is_never_swapped_for_gloo():
    """NCCL is the default backend of every entry point that joins ranks,
    and a CPU rank asked for NCCL raises rather than switching to gloo."""
    import inspect

    from zgml_tpu_torch.parallel import init_distributed
    from zgml_tpu_torch.parallel.dryrun import dryrun_multichip
    from zgml_tpu_torch.parallel.world import World
    for fn in (init_distributed, dryrun_multichip, World):
        assert inspect.signature(fn).parameters["backend"].default == "nccl", fn
    with pytest.raises(ValueError, match="nccl runs on CUDA devices"):
        init_distributed("nccl", device="cpu", rank=0, world_size=1)
    with pytest.raises(ValueError, match="backend"):
        init_distributed("mpi", device="cpu", rank=0, world_size=1)
    src = "".join(p.read_text() for p in (REPO / "zgml_tpu_torch" / "parallel").glob("*.py"))
    assert "is_nccl_available" not in src and "else \"gloo\"" not in src
