"""End-to-end trim times through the CLI, and where the time goes.

Writes the seeded inputs of ``chip_smoke.py`` phase 3 (SE 100 bp reads,
PE 125 bp pairs) and times each of its four trims (SE ``-a``, PE
``--aligner adapter``, PE ``--aligner insert``, SE ``-q 20``): one
compiling prefix run, then ``--repeat`` full runs, each printed as a
single-run figure.

    python tools/perf_e2e.py [--se N] [--pe N] [--repeat N] [--profile FILE]

``--profile FILE`` also writes a cProfile (cumulative, top 60) of one
full run of each trim to FILE, so the host/device split is visible.
"""
import argparse
import cProfile
import io
import os
import pstats
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _profile(run):
    prof = cProfile.Profile()
    prof.enable()
    run()
    prof.disable()
    stream = io.StringIO()
    pstats.Stats(prof, stream=stream).sort_stats("cumulative").print_stats(60)
    return stream.getvalue()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--se", type=int, default=1_000_000)
    parser.add_argument("--pe", type=int, default=500_000)
    parser.add_argument("--repeat", type=int, default=2)
    parser.add_argument("--profile", metavar="FILE")
    args = parser.parse_args(argv)

    from atropos_tpu import configure_compile_cache

    configure_compile_cache()
    import chip_smoke

    reports = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = chip_smoke.write_inputs(tmp, args.se, args.pe)
        print("inputs written in %.1f s" % (time.perf_counter() - t0))
        for label, build, mode, unit in chip_smoke.trim_runs(paths, tmp):
            count = args.se if mode == "se" else args.pe
            chip_smoke._trim(build(False, "warm")[0])
            argv_full = build(True, "full")[0]
            for _ in range(args.repeat):
                seconds = chip_smoke._trim(argv_full)
                print("e2e %s: %d %s in %.3f s = %.0f %s/s" % (
                    label, count, unit, seconds, count / seconds, unit
                ), flush=True)
            if args.profile:
                reports.append("== %s\n" % label + _profile(
                    lambda: chip_smoke._trim(argv_full)))
    if args.profile:
        with open(args.profile, "w") as handle:
            handle.write("\n".join(reports))


if __name__ == "__main__":
    main()
