"""Device ms of the network's elementwise passes (the ``elementwise and
other`` and ``reductions`` kernel groups) a step of the window: a training
step (``.train``) or an engine batch of patches (``.eval``)."""


def read(r):
    if not r.device or not r.steps:
        return None
    return r.group_ms("elementwise and other", "reductions") / r.steps
