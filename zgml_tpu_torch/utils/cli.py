"""Command line: generate token ids from a GGUF model.

Usage: python -m zgml_tpu_torch generate model.gguf --prompt-ids 1,2,3 -n 32
       python -m zgml_tpu_torch report   model.gguf ...   (also prints op placement)
Options: --device cuda|cpu, --kv bf16|int8, --temperature T, --top-k K, --top-p P.

--device cuda (the default) runs the CUDA kernels and fails if they cannot
build or run; --device cpu runs the plain torch versions. --kv int8 keeps
the KV cache in int8 with one scale per position (quant/kv_cache.py).
"""
from __future__ import annotations

import argparse


def cmd_generate(args):
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.sampling import SamplingParams

    model, gf = load_llama(args.model, device=args.device)
    gf.close()
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p)
    eng = LlamaEngine(model, cache_dtype=args.kv, sampling=sampling)
    ids = [int(t) for t in args.prompt_ids.split(",")] if args.prompt_ids else [1]
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
    for name, fn in (("generate", cmd_generate), ("report", cmd_report)):
        p = sub.add_parser(name)
        p.add_argument("model")
        p.add_argument("--prompt-ids", default=None, help="comma-separated token ids")
        p.add_argument("-n", type=int, default=32)
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
        p.add_argument("--kv", default="bf16", choices=["bf16", "int8"])
        p.add_argument("--temperature", type=float, default=0.0)
        p.add_argument("--top-k", type=int, default=0)
        p.add_argument("--top-p", type=float, default=1.0)
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
