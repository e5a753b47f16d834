"""eval_rows_per_s: (user, candidate) rows of every Tester.test() pass
completed in the window (caches rebuilt, every row scored, the group
metrics), over the window's seconds."""


def read(run):
    if not run.units or not run.window_s:
        return None
    return run.units * run.unit_rows / run.window_s
