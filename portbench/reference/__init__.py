"""Plain PyTorch references of the benchmark's configurations, one file a
configuration, in float32 with TF32 off (or a lower precision for the
control). They import nothing of the port and take nothing it made."""
