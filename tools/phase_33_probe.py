#!/usr/bin/env python3
"""Run chip_smoke.py's phase 33 on the card without the phases before it:
the kernels built (phase 1), 33b's rank-thread drill alone, 33a's workers
started beside 33b's two drills over processes (as ``main()`` starts them
beside 32d), then ``phase_control_chaos`` as ``main()`` calls it.  From
the repository root:

    python3 tools/phase_33_probe.py            # phase 33 as main() runs it
    python3 tools/phase_33_probe.py --beside N # 33b's rank-thread drill N
                                               # times alone, then once
                                               # beside 33a's idle workers

``--beside`` shows what 33a's four ready workers (ResNet-50 held on the
card, waiting for their go) do to the drill's step rates: each run prints
its ``steps/rank`` and its verdict.
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _drill(dev, tag):
    job = {cs.CHAOS_THREADS_JOB: cs.chaos_drill_jobs(dev)[
        cs.CHAOS_THREADS_JOB]}
    t0 = time.perf_counter()
    try:
        stdout = cs._run_together(job)[cs.CHAOS_THREADS_JOB][0]
        verdict = "OK"
    except RuntimeError as e:  # the drill's failure, printed
        stdout, verdict = str(e), "FAILED"
    steps = [ln for ln in stdout.splitlines() if "steps/rank" in ln]
    print(f"{tag}: {verdict}, {steps}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    return verdict == "OK"


def main(argv):
    dev = torch.device("cuda", 0)
    cs.phase_build()
    if argv[:1] == ["--beside"]:
        ok = all([_drill(dev, f"alone {i}") for i in range(int(argv[1]))])
        ctl = cs.start_control(dev)
        try:
            while not all(os.path.exists(os.path.join(
                    ctl["bdir"].name, f"ready.{r}")) for r in range(cs.CTL_N)):
                time.sleep(0.05)
            ok = _drill(dev, "beside 33a's ready workers") and ok
        finally:
            for p in ctl["procs"]:
                p.kill()
                p.wait()
            ctl["bdir"].cleanup()
        return 0 if ok else 1
    drills = cs.chaos_drill_jobs(dev)
    threads = cs._run_together({cs.CHAOS_THREADS_JOB:
                                drills.pop(cs.CHAOS_THREADS_JOB)})
    ctl = cs.start_control(dev)
    try:
        beside = cs._run_together(drills)
    except BaseException:
        for p in ctl["procs"]:
            p.kill()
        raise
    t0 = time.perf_counter()
    cs.phase_control_chaos(dev, ctl, beside, threads)
    print(f"phase 33 passed in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
