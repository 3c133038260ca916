"""Closed loop, one caller: ``engine.search`` on each of the pool's batches
in turn, cycled, waiting for each answer, until ``stop``. Each call gets a
new copy of its pool batch, made before its clock starts, as a user's
batches are new buffers. A call is timed from its start to its host
result."""

from perfbench.core import Window


def run(engine, pool, k, stop, clock) -> Window:
    win = Window(serial=True)
    i = 0
    while True:
        j = i % len(pool)
        q = pool[j].copy()
        if stop(i, clock()):
            return win
        t = clock()
        res = engine.search(q, k)
        done = clock()
        win.taken.append(t)
        win.ready.append(done)
        win.pool.append(j)
        win.answers.append((res.indices, res.distances))
        i += 1
