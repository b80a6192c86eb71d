"""zgml_tpu_torch — the PyTorch + CUDA port of zgml_tpu for NVIDIA Hopper.

The JAX package ``zgml_tpu`` is the reference; this package mirrors its module
names so each counterpart is easy to find, and imports neither ``jax`` nor
anything from ``zgml_tpu``:

- ``zgml_tpu_torch.quant``   — numpy Q4_0/Q8_0 codecs, the torch ``PackedWeight``.
- ``zgml_tpu_torch.io``      — numpy GGUF reader/writer, the llama loader.
- ``zgml_tpu_torch.ops``     — plain torch references (``refs``), the
                               hand-written CUDA kernels (``csrc/``, built by
                               ``ops.build``) and their wrappers, ``dispatch``.
- ``zgml_tpu_torch.models``  — the llama model over a stacked bf16 KV cache,
                               and its training forward.
- ``zgml_tpu_torch.runtime`` — engine (chunked prefill, greedy/sampled decode),
                               sampling, placement counters.
- ``zgml_tpu_torch.nn``, ``optim``, ``data`` — losses, the training loops,
                               SGD / Adam, the batch loader.

Tensors on a CUDA device go through the kernels; tensors on the CPU go through
the plain torch versions. No other device is accepted.
"""

__version__ = "0.1.0"
