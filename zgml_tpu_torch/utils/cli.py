"""Command line: inspect a GGUF, or generate tokens from it.

Usage: python -m zgml_tpu_torch inspect  model.gguf [-v]
       python -m zgml_tpu_torch generate model.gguf --prompt "Hello" -n 32
       python -m zgml_tpu_torch generate model.gguf --prompt-ids 1,2,3 -n 32
       python -m zgml_tpu_torch report   model.gguf ...   (also prints op placement)
Options: --device cuda|cpu, --mode quantized|dense, --kv bf16|int8,
--temperature T, --top-k K, --top-p P.

Counterpart of zgml_tpu/utils/cli.py: `inspect` prints the same lines, and
--prompt encodes the text with the BPE tokenizer the GGUF carries
(io/tokenizer.py). --device cuda (the default) runs the CUDA kernels and
fails if they cannot build or run; --device cpu runs the plain torch
versions. --mode dense loads every matmul weight as f32 [K, N]. --kv int8
keeps the KV cache in int8 with one scale per position (quant/kv_cache.py).
"""
from __future__ import annotations

import argparse
import collections


def cmd_inspect(args):
    from zgml_tpu_torch.io.gguf import GGUFFile
    with GGUFFile(args.model) as gf:
        print(f"file: {args.model}")
        print(f"gguf version: {gf.version}, alignment: {gf.alignment}")
        arch = gf.metadata.get("general.architecture", "?")
        print(f"architecture: {arch}")
        interesting = [k for k in gf.metadata
                       if k.startswith((arch + ".", "general."))
                       and not isinstance(gf.metadata[k], list)]
        for k in sorted(interesting):
            print(f"  {k} = {gf.metadata[k]}")
        census = collections.Counter(info.ggml_type.name for info in gf.tensors.values())
        total_params = sum(info.n_elems for info in gf.tensors.values())
        total_bytes = sum(info.nbytes for info in gf.tensors.values())
        print(f"tensors: {len(gf.tensors)}  params: {total_params/1e6:.1f}M  "
              f"size: {total_bytes/1e6:.1f} MB")
        for name, cnt in census.most_common():
            print(f"  {name}: {cnt} tensors")
        if args.verbose:
            for name, info in gf.tensors.items():
                print(f"  {name:<40} {info.ggml_type.name:<6} {info.np_shape}")


def cmd_generate(args):
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.io.tokenizer import BPETokenizer
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.sampling import SamplingParams

    model, gf = load_llama(args.model, device=args.device, mode=args.mode)
    try:
        if args.prompt_ids:
            ids = [int(t) for t in args.prompt_ids.split(",")]
        elif args.prompt is not None:
            ids = BPETokenizer.from_gguf(gf).encode(args.prompt)
        else:
            ids = [1]
    finally:
        gf.close()
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p)
    eng = LlamaEngine(model, cache_dtype=args.kv, sampling=sampling)
    out = eng.generate(ids, args.n)
    print("prompt ids:", ids)
    print("output ids:", out)


def cmd_report(args):
    """generate, then the placement counts: a plain-tier call on the card
    would show here."""
    from zgml_tpu_torch.runtime.profile import global_profile
    cmd_generate(args)
    print(global_profile.render())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zgml_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect", help="print GGUF metadata/tensor census")
    p.add_argument("model")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_inspect)

    for name, fn in (("generate", cmd_generate), ("report", cmd_report)):
        p = sub.add_parser(name)
        p.add_argument("model")
        p.add_argument("--prompt", default=None, help="text, encoded with the GGUF's tokenizer")
        p.add_argument("--prompt-ids", default=None, help="comma-separated token ids")
        p.add_argument("-n", type=int, default=32)
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
        p.add_argument("--mode", default="quantized", choices=["quantized", "dense"])
        p.add_argument("--kv", default="bf16", choices=["bf16", "int8"])
        p.add_argument("--temperature", type=float, default=0.0)
        p.add_argument("--top-k", type=int, default=0)
        p.add_argument("--top-p", type=float, default=1.0)
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
