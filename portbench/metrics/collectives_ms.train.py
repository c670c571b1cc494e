"""Device ms a training step of the collectives (the ``collectives`` kernel
group: NCCL's all-reduces of the batch statistics and the gradients) in
rank 0's trace."""


def read(r):
    if not r.device or not r.steps:
        return None
    ms = r.group_ms("collectives")
    if ms <= 0:
        return None
    return ms / r.steps
