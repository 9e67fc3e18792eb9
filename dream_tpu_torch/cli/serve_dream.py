"""Online pose-serving CLI: the port's ``scripts/serve_dream.py``.

Serves a checkpoint (or, with ``--artifact``, a ``torch.export`` artifact
of ``dream_tpu_torch.cli.export_inference``) over HTTP/JSON with
:mod:`dream_tpu_torch.serve`, on the card unless ``--device cpu``.
``--port 0`` binds a free port; the line it prints names the port bound.

Example:
  python3 -m dream_tpu_torch.cli.serve_dream \\
      -i trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack -b panda_link0 -p 8080

Then from the robot side:
  curl -X POST localhost:8080/camera_info -d '{"fx":615,"fy":615,"cx":320,"cy":240}'
  curl -X POST localhost:8080/keypoint_positions -d '[[x,y,z], ...]'   # live FK
  curl -X POST localhost:8080/image --data-binary @frame.png
  curl localhost:8080/pose
"""

from __future__ import annotations

import argparse
import os

from dream_tpu_torch.network import create_network_from_config_file
from dream_tpu_torch.serve import ArtifactInference, DreamInferenceServer, make_http_server
from dream_tpu_torch.utils.config import load_yaml


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--input-params-path", default=None,
                        help="Checkpoint to serve (required unless --artifact).")
    parser.add_argument("-c", "--network-config", default=None)
    parser.add_argument("--artifact", default=None,
                        help="Serve a torch.export artifact (dream_tpu_torch.cli.export_inference) "
                             "instead of a checkpoint: needs only torch at serving time; keypoint "
                             "names come from --manip-config or the artifact's .meta.json, and "
                             "--device must be the one it was exported on.")
    parser.add_argument("-m", "--manip-config", default=None,
                        help="Manipulator YAML (keypoint names) when serving an --artifact.")
    parser.add_argument("-b", "--base-frame", required=True,
                        help="Robot base frame name for the published pose.")
    parser.add_argument("-p", "--port", type=int, default=8080, help="0 binds a free port.")
    parser.add_argument("--host", default="127.0.0.1",
                        help="Bind address. Loopback by default: the API is unauthenticated; pass "
                             "0.0.0.0 to expose it on the network deliberately.")
    parser.add_argument("--multi-frame", action="store_true", default=False,
                        help="Accumulate correspondences across captured frames (reference's "
                             "multi-frame calibration mode).")
    parser.add_argument("--max-reproj-err-px", type=float, default=None,
                        help="Reject PnP solutions whose mean reprojection error exceeds this many "
                             "pixels (off by default, matching the reference).")
    parser.add_argument("--pnp-reject-outliers-px", type=float, default=None,
                        help="Drop correspondences reprojecting worse than this many px after a "
                             "first solve, then fully re-solve (same semantics as "
                             "network_inference_dataset).")
    parser.add_argument("--pnp-soft-detections", action="store_true", default=False,
                        help="Feed PnP the best belief-map peak for every keypoint above the score "
                             "floor, even those the score-gap disambiguation rejects (published "
                             "keypoint detections are unaffected).")
    parser.add_argument("--pnp-soft-min-score", type=float, default=0.05)
    parser.add_argument("--int8-calibration-frames", type=int, default=0,
                        help="After this many served frames (run in float and used as calibration "
                             "data), switch the network to int8: vgg-Q's chain of int8 conv kernels, "
                             "the quantized conv graph of any other network (DREAM_INT8_IMPL "
                             "picks; 0 = float serving).")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    parser.add_argument("-v", "--verbose", action="store_true", default=False)
    return parser


def build_server(args: argparse.Namespace):
    """``(DreamInferenceServer, bound HTTP server)`` for the parsed flags."""
    if args.artifact:
        if args.int8_calibration_frames or args.pnp_soft_detections:
            raise ValueError("online int8 calibration / soft detections need the full network; "
                             "the artifact bakes these choices at export time.")
        if args.manip_config:
            manip = load_yaml(args.manip_config)["manipulator"]
            net = ArtifactInference(
                args.artifact,
                [k["name"] for k in manip["keypoints"]],
                [k.get("friendly_name", k["name"]) for k in manip["keypoints"]],
                device=args.device,
            )
        else:
            net = ArtifactInference(args.artifact, device=args.device)
    else:
        if not args.input_params_path:
            raise ValueError("-i/--input-params-path is required unless --artifact")
        network_config_path = args.network_config or os.path.splitext(
            args.input_params_path)[0] + ".yaml"
        net = create_network_from_config_file(network_config_path, args.input_params_path,
                                              device=args.device)
    server = DreamInferenceServer(
        net,
        base_frame=args.base_frame,
        single_frame_mode=not args.multi_frame,
        verbose=args.verbose,
        max_reproj_err_px=args.max_reproj_err_px,
        pnp_reject_outliers_px=args.pnp_reject_outliers_px,
        pnp_soft_detections=args.pnp_soft_detections,
        pnp_soft_min_score=args.pnp_soft_min_score,
        int8_calibration_frames=args.int8_calibration_frames,
    )
    return server, make_http_server(server, args.host, args.port)


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    _, httpd = build_server(args)
    host, port = httpd.server_address[:2]
    print(f"dream_tpu_torch serving on {host}:{port} (single_frame_mode={not args.multi_frame})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
