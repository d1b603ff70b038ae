"""Far-range banded-depth evaluation: the regime the PROPOSED method wins.

Runs every method on the far scene (3-5.5 m, Kinect-v1 quantization bands
many pixels wide — core/testdata.py::make_banded_scene) against the TRUE
geometry, plus a sparse variant with coherent dropouts.  Writes the report
(+ optional 6-viewport comparison PNG) consumed by EVAL_FAR.md.

Usage: python scripts/eval_far_range.py [out.txt] [--figure cmp.png]
       [--holes 0.15] [--grid 15x20] [--full]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kinectdepthmapenhancement_tpu.core import device

device.enable_compile_cache()


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("--") \
        else "eval_far.txt"
    figure = None
    if "--figure" in sys.argv:
        figure = sys.argv[sys.argv.index("--figure") + 1]
    holes = (
        float(sys.argv[sys.argv.index("--holes") + 1])
        if "--holes" in sys.argv
        else 0.0
    )

    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu.core.testdata import make_banded_scene
    from kinectdepthmapenhancement_tpu.utils import evaluate

    h, w = 480, 640
    intr = default_kinect_intrinsics(w, h)
    color, sensor, gt = make_banded_scene(
        h, w, intr, seed=0, hole_fraction=holes
    )
    results = evaluate.evaluate(
        sensor,
        color,
        gt,
        include_sp_methods="--full" in sys.argv,
        intr=intr,
        timing_iters=3,
        figure_path=figure,
        # sparse variant: also score KDE with the label-consistent plane
        # hole-fill (8x8 dropouts -> 4 dilation steps reach hole centres)
        fill_steps=4 if holes > 0.0 else 0,
        # round 5: the plane-consistency merge rows (kde_pm / kde_pm_fill)
        plane_merge=True,
    )
    print(evaluate.write_report(out, results))


if __name__ == "__main__":
    main()
