"""Command line of the port: ``python -m facet_tpu_torch <dir> --pass quality``.

The scan path of ``photos.py`` for the passes the port runs:
``--pass quality|embeddings|tags``, with ``--db``, ``--config``, ``--force``,
``--limit`` and ``--speed-tier``. It runs on the card; ``--device cpu`` asks
for the CPU (the counterpart of photos.py's JAX platform setting), and
without a usable card and that flag it exits with an error. The default
multi-pass scan and ``--single-pass`` need ensemble members that are not
ported yet, so they exit non-zero and name those members instead of
silently scoring fewer; every other ``photos.py`` mode exits with "not yet
ported".
"""

import argparse
import os
import sys

from facet_tpu_torch.processing.multi_pass import PASS_NAMES, PORTED_PASSES


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m facet_tpu_torch",
        description="facet photo scan on the PyTorch/CUDA port")
    p.add_argument("directory", nargs="?", help="photo directory to scan")
    p.add_argument("--db", default=None, help="database path (default photo_scores_pro.db)")
    p.add_argument("--config", default=None, help="scoring config path")
    p.add_argument("--pass", dest="pass_name", default=None, choices=sorted(PASS_NAMES),
                   help="run one pass over the photos")
    p.add_argument("--single-pass", action="store_true",
                   help="photos.py's streaming mode (not yet ported)")
    p.add_argument("--force", action="store_true", help="rescan already-scored photos")
    p.add_argument("--limit", type=int, default=None, help="max photos this run")
    p.add_argument("--speed-tier", choices=["exact", "fast"], default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the models and kernels run (default: the card; "
                        "the CPU only when asked)")
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        print(f"not yet ported to facet_tpu_torch: {' '.join(unknown)} "
              f"(use photos.py)", file=sys.stderr)
        return 2
    if not args.directory:
        build_parser().print_help()
        return 1
    if not os.path.isdir(args.directory):
        print(f"error: {args.directory} is not a directory", file=sys.stderr)
        return 1

    from facet_tpu_torch.config.scoring_config import ScoringConfig
    from facet_tpu_torch.db.connection import resolve_db_path
    from facet_tpu_torch.models.model_manager import resolve_device
    from facet_tpu_torch.processing.multi_pass import ChunkedMultiPassProcessor
    from facet_tpu_torch.processing.scorer import Facet
    from facet_tpu_torch.utils.burst import process_bursts
    from facet_tpu_torch.utils.image_loading import gather_image_files

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    db_path = resolve_db_path(args.db)
    config = ScoringConfig(args.config)
    if args.speed_tier:
        # in-memory override only, as photos.py does
        config.config.setdefault("processing", {})["speed_tier"] = args.speed_tier
    scorer = Facet(db_path, config, device=device)

    if args.pass_name is None or args.single_pass:
        mode = "--single-pass" if args.single_pass else "the default multi-pass scan"
        missing = scorer.models.unported(scorer.models.select_models(config))
        print(f"{mode} is not yet ported to facet_tpu_torch: it needs "
              f"{missing or 'the streaming batch processor'}; run --pass "
              f"{'|'.join(PORTED_PASSES)} or use photos.py", file=sys.stderr)
        return 2
    if args.pass_name not in PORTED_PASSES:
        missing = scorer.models.unported(PASS_NAMES[args.pass_name])
        print(f"--pass {args.pass_name} is not yet ported to facet_tpu_torch: "
              f"it needs {missing}", file=sys.stderr)
        return 2

    scanning = config.get_scanning_settings()
    files = gather_image_files(args.directory,
                               skip_hidden=scanning.get("skip_hidden_directories", True))
    if not args.force:
        done = scorer.get_already_scanned_set()
        files = [f for f in files if os.path.abspath(f) not in done and f not in done]
    files = [os.path.abspath(f) for f in files]
    if args.limit:
        files = files[: args.limit]
    if not files:
        print("nothing to scan (all photos already scored; --force to rescan)")
        return 0
    print(f"found {len(files)} photos to process")

    ChunkedMultiPassProcessor(scorer).run_single_pass(files, args.pass_name)

    # post-scan: burst grouping + tag backfill from stored embeddings
    process_bursts(db_path, config)
    try:
        scorer.retag_from_embeddings(only_untagged=True, verbose=True)
    except Exception as exc:
        print(f"tag backfill skipped: {exc}")
    print("scan complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
