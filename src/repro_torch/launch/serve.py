"""Serving launcher:  PYTHONPATH=src python -m repro_torch.launch.serve \
    --arch llama3-8b --seq 1024 --batch 4 --new-tokens 16

Runs on the ``cuda`` device unless ``--device cpu`` is given."""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, ShapeSpec, get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.runtime.serve_loop import ServeConfig, serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    params = lm.init(cfg, seed=0, device=device)
    batch = make_batch(cfg, ShapeSpec("cli", args.seq, args.batch, "prefill"))
    res = serve(cfg, params, batch, ServeConfig(max_new_tokens=args.new_tokens),
                device=device)
    print(f"prefill {res['prefill_s']*1e3:.0f} ms, "
          f"decode {res['tokens_per_s']:.1f} tok/s, "
          f"first row: {res['tokens'][0][:8].tolist()}")
    return res


if __name__ == "__main__":
    main()
