"""View a trained run live (counterpart of
``nerfstudio_tpu/scripts/viewer_script.py``; reference
nerfstudio/scripts/viewer/run_viewer.py):

    python -m nerfstudio_torch.scripts.viewer_script RUN_DIR [--port 7007]

Loads the run's config and latest checkpoint on the device its config names
(the GPU unless it says ``cpu``), serves the websocket on PORT and the
client page on PORT + 1, and renders until interrupted."""

from __future__ import annotations

import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m nerfstudio_torch.scripts.viewer_script RUN_DIR [--port 7007]")
        return
    run_dir = Path(argv[0])
    args = dict(zip(argv[1::2], argv[2::2]))
    port = int(args.get("--port", "7007"))

    from nerfstudio_torch.utils.eval_utils import eval_setup
    from nerfstudio_torch.viewer.server import Viewer

    _, pipeline, state = eval_setup(run_dir)
    viewer = Viewer(pipeline, lambda: state, websocket_port=port, http_port=port + 1)
    viewer.start()
    print("press ctrl-c to exit", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        viewer.stop()


def entrypoint():
    main()


if __name__ == "__main__":
    entrypoint()
