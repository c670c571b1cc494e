"""Host ms of the train step's own work: the benchmark's span around
``Trainer.train_step`` less the time the host spent inside CUDA runtime
and driver calls (launches that wait on a full queue, the batch's blocking
upload, synchronises), the mean over the window's steps. Nothing without
the trace's runtime events, since the span alone is device-paced."""

SPAN = "portbench.train_step"


def read(r):
    own = r.host_ms.get(SPAN)
    if not own:
        return None
    return sum(own) / len(own)
