"""train_impr_per_s: training rows (a click and its negatives) of every
step completed in the window, over the window's seconds (dispatch to the
device's end of the last step)."""


def read(run):
    if not run.units or not run.window_s:
        return None
    return run.units * run.unit_rows / run.window_s
