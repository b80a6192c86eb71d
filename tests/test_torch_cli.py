"""The port's command line (zgml_tpu_torch/utils/cli.py) against the JAX
package's (zgml_tpu/utils/cli.py) on the same files, on the CPU:

  - `inspect` (and `inspect -v`) prints the JAX lines, character for
    character, for a uniform and a mixed-kind GGUF;
  - `generate --prompt` encodes the text with the tokenizer the GGUF carries
    (built before the file is closed) into JAX's ids, and prints them as
    JAX does; the tokens it generates are in the vocabulary;
  - `--device cpu` with `--mode dense` and with `--kv int8` run, and the
    default device (the card) raises without one;
  - `report` prints the placement after the tokens.
"""
import dataclasses
import os

import pytest
import torch

from zgml_tpu.utils import cli as jax_cli

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.tokenizer import BPETokenizer
from zgml_tpu_torch.utils import cli
from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "bpe")
CFG = dataclasses.replace(TINY_TEST, vocab_size=4608)
PROMPTS = ["Hello world, the model", "def forward(self, x):\n    return x"]


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    tok = BPETokenizer.from_files(os.path.join(DATA, "vocab.json"),
                                  os.path.join(DATA, "merges.txt"))
    mixed = {"blk.0.attn_v.weight": GGMLType.Q8_0, "blk.1.ffn_up.weight": GGMLType.Q8_0,
             "output.weight": GGMLType.Q8_0}
    out = {"uniform": str(d / "uniform.gguf"), "mixed": str(d / "mixed.gguf")}
    write_synthetic_llama_gguf(out["uniform"], CFG, GGMLType.Q4_0, seed=1, tokenizer=tok)
    write_synthetic_llama_gguf(out["mixed"], CFG, GGMLType.Q4_0, seed=2, kinds=mixed,
                               tokenizer=tok)
    return out


def _lines(capsys, main, argv):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("verbose", [[], ["-v"]])
@pytest.mark.parametrize("name", ["uniform", "mixed"])
def test_inspect_prints_the_jax_lines(ggufs, capsys, name, verbose):
    argv = ["inspect", ggufs[name], *verbose]
    got = _lines(capsys, cli.main, argv)
    assert got == _lines(capsys, jax_cli.main, argv)
    assert any(line.strip() == "Q8_0: 3 tensors" for line in got) == (name == "mixed")


def _ids(lines, label):
    line = next(ln for ln in lines if ln.startswith(label))
    return [int(t) for t in line[len(label):].strip(" []").split(",")]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_generate_prompt_gives_the_jax_ids(ggufs, capsys, monkeypatch, prompt):
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    argv = ["generate", ggufs["mixed"], "--prompt", prompt, "-n", "4"]
    got = _lines(capsys, cli.main, argv + ["--device", "cpu"])
    want = _lines(capsys, jax_cli.main, argv)
    assert got[0] == want[0] and got[0].startswith("prompt ids: [")
    out = _ids(got, "output ids:")
    assert len(out) == 4 and all(0 <= t < CFG.vocab_size for t in out)


@pytest.mark.parametrize("extra", [["--mode", "dense"], ["--kv", "int8"],
                                   ["--mode", "dense", "--kv", "int8"]])
def test_generate_runs_on_the_cpu(ggufs, capsys, extra):
    lines = _lines(capsys, cli.main, ["generate", ggufs["uniform"], "--prompt", PROMPTS[0],
                                      "-n", "3", "--device", "cpu", *extra])
    assert len(_ids(lines, "output ids:")) == 3


def test_report_prints_the_placement(ggufs, capsys):
    lines = _lines(capsys, cli.main, ["report", ggufs["mixed"], "--prompt-ids", "5,6,7",
                                      "-n", "3", "--device", "cpu"])
    assert _ids(lines, "prompt ids:") == [5, 6, 7]
    assert "== op placement ==" in lines
    assert any(ln.split()[0] == "qmatmul_i8_q8" for ln in lines if ln.startswith("  "))


def test_default_device_is_the_card(ggufs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["generate", ggufs["uniform"], "--prompt", PROMPTS[0], "-n", "2"])
