#!/usr/bin/env python3
"""Host cost of the port's NIfTI path at BraTS's 240×240×155, on the machine
that holds the card:

    python3 scripts/probe_torch_nifti_io.py

Prints the seconds to build the native reader (0 when it is built already),
to write one synthetic subject (4 gzip writes, ``data.synthetic``), to decode
one volume with the native reader and with the numpy reader (the two must be
bitwise equal), and to decode the subject's 4 volumes at once on the native
reader's thread pool; then holds ``preprocess_slice_batch`` over the central
slices on the card against the CPU. Needs one CUDA card.
"""

import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mrijax_torch.data import cnifti, nifti, preprocess, synthetic  # noqa: E402

SHAPE = (240, 240, 155)


def seconds(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_nifti_io: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)} | torch {torch.__version__}")
    _, t = seconds(cnifti.build)
    print(f"native reader build s {t:.3f}")
    with tempfile.TemporaryDirectory() as d:
        _, t = seconds(lambda: synthetic.write_synthetic_brats(d, 1, SHAPE))
        print(f"write 1 subject s {t:.3f}")
        paths = sorted(Path(d).rglob("*.nii.gz"))
        native, t = seconds(lambda: cnifti.load(paths[0]))
        print(f"native decode s {t:.3f}")
        plain, t = seconds(lambda: nifti.load(paths[0]))
        print(f"numpy decode s {t:.3f}")
        if not np.array_equal(native, plain):
            raise AssertionError("the native and numpy readers differ")
        _, t = seconds(lambda: cnifti.load_batch(paths))
        print(f"native load_batch of {len(paths)} s {t:.3f}")
    raw = torch.from_numpy(np.ascontiguousarray(np.moveaxis(native[:, :, 15:139], -1, 0)))
    err = float((preprocess.preprocess_slice_batch(raw.cuda(), 128).cpu()
                 - preprocess.preprocess_slice_batch(raw, 128)).abs().max())
    print(f"preprocess_slice_batch card vs CPU max abs err {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
