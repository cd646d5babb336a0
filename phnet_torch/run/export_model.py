"""Export a model as a deployment artifact (counterpart of the root
``tools/export_model.py``).

Takes a checkpoint of ``phnet_torch.train`` or a reference ``.pth.tar``
and writes a ``phnet_torch.export`` artifact directory: the serving tick
as a ``torch.export`` program with its weights, the state dict and the
memory template. ``phnet_torch.export.DeployedServer`` serves it without
building the model.

    python -m phnet_torch.run.export_model --checkpoint models/VIL100/best \\
        --out art/ --batch 4
    python -m phnet_torch.run.export_model --torch-checkpoint best.pth.tar \\
        --preset openlane --batch 8 --quantize w8 --out art/

The artifact runs on the device type it was exported on: the card unless
``--device cpu``. ``main(argv, cfg)`` takes a configuration in place of
the preset's (the tests' small one).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .common import load_weights, resolve_quantize, with_quantize


def main(argv: Optional[Sequence[str]] = None, cfg=None) -> str:
    ap = argparse.ArgumentParser(prog="python -m phnet_torch.run.export_model")
    ap.add_argument("--checkpoint", default=None,
                    help="a checkpoint of phnet_torch.train: "
                         "<workdir>/<name>, name 'best' or an epoch")
    ap.add_argument("--torch-checkpoint", default=None,
                    help="reference RouterWithB .pth(.tar) checkpoint to "
                         "import (unpickled: load only trusted files)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--preset", choices=("vil100", "openlane"),
                    default="vil100")
    ap.add_argument("--batch", type=int, default=1,
                    help="streams per tick (serving batch)")
    ap.add_argument("--window", type=int, default=None,
                    help="temporal memory window (default: preset)")
    ap.add_argument("--int8", action="store_true",
                    help="shorthand for --quantize int8")
    ap.add_argument("--quantize", choices=("none", "int8", "w8"),
                    default="none",
                    help="bake a quantized serving graph into the artifact: "
                         "int8 = dynamic w8a8, w8 = weight-only int8 (the "
                         "w8 matmul kernel on the card)")
    ap.add_argument("--device", default=None,
                    help="torch device the artifact runs on (default: the "
                         "card)")
    args = ap.parse_args(argv)
    resolve_quantize(ap, args)

    from ..config import openlane_config, vil100_config
    from ..device import resolve_device
    from ..export import export_serving_step

    if cfg is None:
        cfg = vil100_config() if args.preset == "vil100" else openlane_config()
    device = resolve_device(args.device)
    if not (args.checkpoint or args.torch_checkpoint):
        print("warning: exporting with randomly initialized weights "
              "(no --checkpoint / --torch-checkpoint)", file=sys.stderr)
    # the weights of the unquantized model: quantize only changes the
    # served graph
    state_dict = load_weights(cfg, args, None, device)
    out = export_serving_step(
        with_quantize(cfg, args.quantize).model, state_dict, args.out,
        batch=args.batch, memory_window=args.window, device=device)
    print(f"exported {args.preset} serving step (batch={args.batch}"
          f"{', ' + args.quantize if args.quantize != 'none' else ''}, "
          f"{device.type}) -> {out}")
    return out


if __name__ == "__main__":
    main()
