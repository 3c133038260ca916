"""Queries answered within the window, per second of the window."""


def read(run):
    done = run.done()
    return len(done) * run.batch / run.seconds if done else None
