"""Command line of the port: ``python -m facet_tpu_torch <dir>``.

The scan path of ``photos.py``: the default multi-pass scan and
``--pass quality|embeddings|tags|composition|faces``, with ``--db``,
``--config``, ``--force``, ``--limit`` and ``--speed-tier``. It runs on the
card; ``--device cpu`` asks for the CPU (the counterpart of photos.py's JAX
platform setting), and without a usable card and that flag it exits with
an error. A default scan whose profile selects a member that is not ported
yet (the VLM tagger of the "24gb" profile, which ``vram_profile: auto``
picks on a card of 20 GB or more) exits non-zero and names that member
instead of silently scoring fewer; so do ``--single-pass`` and
``--dry-run``, naming what they need, and a scan that holds the faces
member while a converted 2d106det landmark graph is installed (its runner
is not ported), before any row is written. Every other ``photos.py`` mode exits
with "not yet ported".
"""

import argparse
import os
import sys

from facet_tpu_torch.processing.multi_pass import PASS_NAMES


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
    p.add_argument("--dry-run", action="store_true",
                   help="photos.py's score-without-saving preview (not yet ported)")
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

    if args.single_pass or args.dry_run:
        mode, needs = (("--single-pass", "the streaming BatchProcessor "
                        "(processing/batch_processor.py)") if args.single_pass else
                       ("--dry-run", "Facet.score_paths, the per-photo scoring path"))
        print(f"{mode} is not yet ported to facet_tpu_torch: it needs {needs}; run "
              f"the default scan or --pass {'|'.join(PASS_NAMES)}, or use photos.py",
              file=sys.stderr)
        return 2
    if args.pass_name is None:
        missing = scorer.models.unported(scorer.models.select_models(config))
        if missing:
            profile = config.get_model_config().get("vram_profile")
            print(f"the default multi-pass scan under the '{profile}' profile is not "
                  f"yet ported to facet_tpu_torch: it needs {missing}; set "
                  f"models.vram_profile to a profile without them (\"16gb\" runs "
                  f"TOPIQ, SAMP-Net, CLIP tagging and faces), run --pass "
                  f"{'|'.join(PASS_NAMES)}, or use photos.py", file=sys.stderr)
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

    processor = ChunkedMultiPassProcessor(scorer)
    try:
        if args.pass_name:
            processor.run_single_pass(files, args.pass_name)
        else:
            processor.process_directory(files)
    except NotImplementedError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

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
