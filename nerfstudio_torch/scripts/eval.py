"""Average eval-image metrics of a trained run as JSON (counterpart of
``nerfstudio_tpu/scripts/eval.py``):

    python -m nerfstudio_torch.scripts.eval RUN_DIR [--output-path out.json]

PSNR, SSIM, LPIPS (where ``utils.lpips.eval_lpips`` reports it), rays/s and
fps over every eval image, mean and std."""

from __future__ import annotations

import json
import sys
from pathlib import Path


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m nerfstudio_torch.scripts.eval RUN_DIR [--output-path out.json]")
        return {}
    run_dir = Path(argv[0])
    out_path = Path(argv[argv.index("--output-path") + 1]) if "--output-path" in argv else Path("eval.json")

    from nerfstudio_torch.utils.eval_utils import eval_setup

    config, pipeline, state = eval_setup(run_dir)
    metrics = pipeline.get_average_eval_image_metrics(state)
    info = {"experiment_name": config.trainer.experiment_name, "method_name": config.method_name,
            "checkpoint": str(run_dir), "step": int(state.step), "results": metrics}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(info, indent=2), "utf8")
    print(json.dumps(metrics, indent=2))
    print(f"saved results to {out_path}", flush=True)
    return info


if __name__ == "__main__":
    main()
