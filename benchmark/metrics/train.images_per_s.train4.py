"""The ``train4`` cell's training rate in images/s: every real image of
the untraced window's completed macro-steps, (dsteps + gsteps) x the
global batch each, over rank 0's window, as ``train_images_per_s`` reads
it in the one-card cells.  Over four ranks the eager step is paced by a
host whose cores share their time with other machines, so runs of one seed
spread by up to a fifth and it is not bounded end to end; it moves
``setup_s``, whose set-up runs the same step."""


def read(run):
    rate = run.get("rate")
    if run.get("kind") != "train4" or not rate or not rate["window_s"]:
        return None
    return rate["images"] / rate["window_s"]
