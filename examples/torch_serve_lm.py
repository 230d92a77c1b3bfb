"""Batched LM serving with the PyTorch port: prefill + decode across the
ten LM archs.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma3-4b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch whisper-large-v3 --device cpu
    PYTHONPATH=src python examples/torch_serve_lm.py --arch zamba2-2.7b --device cpu

An attention arch's prompt is prefilled in one pass into ring-buffer KV
caches (gemma3's local layers mask by window, whisper's decoder also reads
its encoder's cross caches, mixtral and llama4 route through their experts
dropless); a recurrent arch (zamba2, rwkv6) warms its state token by
token.  Then each decodes token by token: ``repro_torch.launch.serve`` at
the arch's reduced config.  Runs on the GPU unless ``--device cpu`` is
given.
"""

import argparse

from repro_torch.launch import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    return serve.main(["--arch", args.arch, "--batch", str(args.batch),
                       "--prompt-len", str(args.prompt_len), "--gen", str(args.gen),
                       "--device", args.device])


if __name__ == "__main__":
    main()
