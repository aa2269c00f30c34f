#!/usr/bin/env python3
"""Time chip_smoke.py's phases 1, 1b, 1c, 17, 18, 19 and 20-21 of one or
more checkouts on the card, each in a fresh interpreter, in turn; with
``--36``, its phase 36a instead (the trainer of phase 3 built first; 36b
runs inside 32c's worker processes and is timed by the whole script's
``[phases]`` line).

    python3 tools/chip_smoke_phases.py [--36] CHECKOUT [CHECKOUT ...]

Each checkout's own phase functions run from its own root, in the order its
``main()`` runs them (its kernels built by its phase 1, the fuse plan made
as its ``main()`` makes it), with every check they hold.  One line a
checkout: ``PHASES <checkout>: 1 s, 1b s, ...; total s``.  Give two
checkouts (a parent and a change) to compare them on one card and one host
in one call; list each more than once to see the spread.
"""

import os
import subprocess
import sys
import tempfile
import time


def run_one(root):
    os.chdir(root)
    sys.path.insert(0, root)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs
    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.ops.collectives import fuse_plan

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    secs = {}
    t = [time.perf_counter()]

    def lap(tag):
        now = time.perf_counter()
        secs[tag] = now - t[0]
        t[0] = now

    t0 = t[0]
    cs.phase_build()
    if hasattr(cs, "_plan_leaves"):
        leaves = cs._plan_leaves()
    else:
        trainer = build("resnet50", "neighbor", "exp2", size=cs.N_RANKS,
                        batch_size=cs.BATCH, image_size=224, device=device)
        leaves = list(trainer.params.values())
        del trainer
    mp_lengths = [sum(leaves[i][0].numel() for i in idx)
                  for idx in fuse_plan(leaves, None)[0].values()]
    win_len = sum(p[0].numel() for p in leaves)
    del leaves
    torch.cuda.empty_cache()
    lap("1")
    bert_dir = tempfile.TemporaryDirectory()
    _, started = cs.phase_processes(device, mp_lengths, win_len,
                                    bert_dir.name)
    lap("1b")
    bert_procs = cs.phase_bert_processes(bert_dir.name, started)
    lap("1c")
    cs.phase_examples()
    lap("17")
    cs.phase_bert(device, bert_dir.name, bert_procs)
    bert_dir.cleanup()
    lap("18")
    cs.phase_bert_finetune()
    lap("19")
    job = cs.start_checkpoint()
    try:
        cs.phase_gates()
    except BaseException:
        cs.stop_checkpoint(job)
        raise
    cs.phase_checkpoint(job)
    lap("20-21")
    print(f"PHASES {root}: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
          + f"; total {time.perf_counter() - t0:.1f} s", flush=True)


def run_36(root):
    """Phase 36a of ``root``: its kernels built, phase 3's trainer built
    and stepped once (``setup``), then
    :func:`chip_smoke.phase_observed_main` (``36a``)."""
    os.chdir(root)
    sys.path.insert(0, root)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs
    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.ops.collectives import fuse_plan

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cs.phase_build()
    leaves = cs._plan_leaves()
    groups, big = fuse_plan(leaves)
    main_lengths = ([sum(leaves[i][0].numel() for i in idx)
                     for idx in groups.values()]
                    + [leaves[i][0].numel() for i in big])
    del leaves
    trainer = build("resnet50", "neighbor", "exp2", size=cs.N_RANKS,
                    batch_size=cs.BATCH, image_size=224, device=device)
    # phase 3's steps come first in chip_smoke: the optimizer's momentum
    # exists when 36a snapshots the state
    trainer.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cs.phase_observed_main(trainer, main_lengths)
    t2 = time.perf_counter()
    print(f"PHASES {root}: setup {t1 - t0:.1f}, 36a {t2 - t1:.1f}; "
          f"total {t2 - t0:.1f} s", flush=True)


def main(argv):
    if argv[:1] in (["--one"], ["--one-36"]):
        (run_one if argv[0] == "--one" else run_36)(
            os.path.abspath(argv[1]))
        return 0
    one = "--one"
    if argv[:1] == ["--36"]:
        one, argv = "--one-36", argv[1:]
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    rc = 0
    for root in argv:
        rc = rc or subprocess.call([sys.executable, os.path.abspath(__file__),
                                    one, os.path.abspath(root)])
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
