"""Closed loop, one client, one batch in flight: the engine's
``search_pipelined`` over the pool's batches, cycled, until ``stop``. Each
batch is handed over as a new copy of its pool batch, made before its
clock starts, as a user's batches are new buffers. A batch is timed from
when the engine takes it to when its host result is ready, so it counts the
wait behind the batch in flight."""

from perfbench.core import Window


def run(engine, pool, k, stop, clock) -> Window:
    win = Window()

    def feed():
        i = 0
        while True:
            j = i % len(pool)
            q = pool[j].copy()
            now = clock()
            if stop(i, now):
                return
            win.taken.append(now)
            win.pool.append(j)
            yield q
            i += 1

    for res in engine.search_pipelined(feed(), k):
        win.ready.append(clock())
        win.answers.append((res.indices, res.distances))
    return win
