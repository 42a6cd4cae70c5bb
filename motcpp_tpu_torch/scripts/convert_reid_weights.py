#!/usr/bin/env python3
"""Convert a torchreid OSNet checkpoint to the JAX package's flat .npz
of Flax variables.

Counterpart of the JAX package's ``scripts/convert_reid_weights.py``:
the same arguments, output layout and message. The conversion is
name-based (torchreid state_dict key -> Flax module path,
``appearance/osnet.py::convert_torch_state_dict``) and covers
BatchNorm running statistics (the ``batch_stats`` collection); it raises
if any tensor of the variant is missing, unmapped or mis-shaped. The
output is a flat .npz with 'params/...' / 'batch_stats/...' keys that
both packages' ``ReIDBackend(weights="out.npz")`` and
``load_npz_variables`` read. Conversion is host work: no device is used.

Usage:
    python -m motcpp_tpu_torch.scripts.convert_reid_weights <weights.pt> <out.npz> [x1_0|x0_75|x0_5|x0_25]
"""

from __future__ import annotations

import sys

from motcpp_tpu_torch.appearance.osnet import (
    convert_torch_state_dict,
    load_torch_weights,
    osnet_x0_5,
    osnet_x0_25,
    osnet_x0_75,
    osnet_x1_0,
    save_npz_variables,
)

VARIANTS = {"x1_0": osnet_x1_0, "x0_75": osnet_x0_75, "x0_5": osnet_x0_5,
            "x0_25": osnet_x0_25}


def convert(src, dst, variant="x1_0") -> int:
    """Convert the checkpoint ``src`` of OSNet ``variant`` into the .npz
    ``dst``; returns the number of tensors written. Raises ValueError
    listing every tensor that is missing, unexpected or mis-shaped for
    the variant."""
    model = load_torch_weights(VARIANTS[variant](), src)
    save_npz_variables(dst, convert_torch_state_dict(model.state_dict()))
    return sum(1 for k in model.state_dict()
               if not k.endswith("num_batches_tracked"))


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    src, dst = argv[0], argv[1]
    variant = argv[2] if len(argv) > 2 else "x1_0"
    n = convert(src, dst, variant)
    print(f"wrote {dst} ({n} tensors, variant {variant})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
