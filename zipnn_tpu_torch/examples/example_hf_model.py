"""Load a ``.znn``-compressed Hugging Face model directory, decoded on the
card.

The counterpart of the JAX package's ``examples/example_hf_model.py``, with
no download: give a local model directory whose weights were compressed by

    python -m zipnn_tpu_torch.cli.compress_path safetensors --path <model-dir>

(then remove the plain ``model.safetensors``)
or ``--demo``, which builds a 2-layer GPT-2 from ``transformers.GPT2Config``
(random weights from seed 0; GPT-2's widths unless ``--n-embd`` /
``--vocab-size`` shrink them), saves it with ``save_pretrained``,
compresses the directory with the port's ``compress_path`` and loads it
through ``zipnn_hf(decode_device=...)`` and ``AutoModel.from_pretrained``:
the state dict equals the original.  transformers finds a local
directory's weights by their plain names, so the plugin decodes each
``.znn`` into the plain file beside it: a given directory is copied into a
temporary one first, and is left as it was.  Needs ``transformers``.

    python -m zipnn_tpu_torch.examples.example_hf_model (<model-dir> | --demo) [--device cpu]
"""
import importlib.util
import os
import shutil
import tempfile

import torch

from zipnn_tpu_torch.examples import device_of, parser, require


def demo_model(n_embd: int, vocab_size: int):
    from transformers import GPT2Config, GPT2Model  # noqa: PLC0415

    cfg = GPT2Config(n_layer=2, n_embd=n_embd, n_head=max(1, n_embd // 64),
                     vocab_size=vocab_size)
    model = GPT2Model(cfg).eval()
    g = torch.Generator().manual_seed(0)  # the weights, whatever the init drew
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    return model


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("model_dir", nargs="?", default=None,
                    help="a local directory of .znn-compressed weights")
    ap.add_argument("--demo", action="store_true",
                    help="build, compress and load a 2-layer GPT-2 here")
    ap.add_argument("--n-embd", type=int, default=768, help="--demo's width (default 768)")
    ap.add_argument("--vocab-size", type=int, default=50257,
                    help="--demo's vocabulary (default 50257)")
    args = ap.parse_args(argv)
    if importlib.util.find_spec("transformers") is None:
        raise SystemExit("example_hf_model needs the transformers package, "
                         "which is not installed")
    if not (args.demo or args.model_dir):
        raise SystemExit("give a local model directory, or --demo")
    dev = device_of(args)
    os.environ.setdefault("USE_TF", "0")

    from transformers import AutoModel  # noqa: PLC0415

    from zipnn_tpu_torch import zipnn_hf  # noqa: PLC0415
    from zipnn_tpu_torch.cli import compress_path  # noqa: PLC0415

    with tempfile.TemporaryDirectory() as d:
        want = None
        path = os.path.join(d, "model")
        if args.model_dir:
            # transformers finds a local directory's weights by their plain
            # names, so the plugin decodes each .znn beside it: in a copy
            shutil.copytree(args.model_dir, path)
        else:
            model = demo_model(args.n_embd, args.vocab_size)
            want = model.state_dict()
            model.save_pretrained(path, safe_serialization=True)
            compress_path.main(["safetensors", "--path", path, "--force", "--device", str(dev)])
            plain = os.path.join(path, "model.safetensors")
            require(os.path.exists(plain + ".znn"), "compress_path wrote no model.safetensors.znn")
            os.remove(plain)  # only the .znn is left to load
        zipnn_hf(replace_local_file=True, decode_device=str(dev))
        loaded = AutoModel.from_pretrained(path)
        got = loaded.state_dict()
    n = sum(p.numel() for p in loaded.parameters())
    print("loaded", args.model_dir or "the demo GPT-2", "->", n, "params")
    if want is not None:
        require(want.keys() == got.keys(), "the loaded state dict's keys")
        for k in want:
            require(torch.equal(want[k], got[k]), f"{k} differs from the saved weights")
        print(f"hf roundtrip OK: {len(want)} tensors equal to the saved model's")
    return {"params": n}


if __name__ == "__main__":
    main()
