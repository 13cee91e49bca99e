"""Serve a ``.znn``-compressed model with vLLM, its tensors decoded on the
card.

The counterpart of the JAX package's ``examples/example_vllm.py``.
``zipnn_safetensors(decode_device=...)`` patches ``safetensors``'
``safe_open`` in this process and in every process spawned from it, so the
compressed tensors of ``*.znn.safetensors`` files decode as vLLM loads
them.  Compress a local model directory first, e.g.

    python -m zipnn_tpu_torch.cli.compress_path safetensors --path <model-dir> --per_tensor

then point this at it (a local path: nothing is downloaded).  Where vLLM
is not installed, it says so and exits 0.

    python -m zipnn_tpu_torch.examples.example_vllm <model-dir> [--device cpu]
"""
import importlib.util

from zipnn_tpu_torch.examples import device_of, parser


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("model_dir", nargs="?", default=None,
                    help="a local directory of a .znn-compressed model")
    args = ap.parse_args(argv)
    dev = device_of(args)
    if importlib.util.find_spec("vllm") is None:
        print("vllm is not installed in this environment; zipnn_safetensors() is")
        print("all the integration needed: install vllm and rerun.")
        return {"ran": False}
    if not args.model_dir:
        raise SystemExit("give a local model directory")

    from vllm import LLM  # noqa: PLC0415

    from zipnn_tpu_torch import zipnn_safetensors  # noqa: PLC0415

    zipnn_safetensors(decode_device=str(dev))
    llm = LLM(args.model_dir)
    outputs = llm.generate(["Once upon a time,"])
    print(outputs[0].outputs[0].text)
    return {"ran": True}


if __name__ == "__main__":
    main()
