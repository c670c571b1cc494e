"""Device ms a training step of the network's convolutions: the ``cuDNN
convolution`` and ``matmul`` kernel groups."""


def read(r):
    if not r.device or not r.steps:
        return None
    return r.group_ms("cuDNN convolution", "matmul") / r.steps
