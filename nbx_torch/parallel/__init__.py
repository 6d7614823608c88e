"""Multi-device paths of the port (`nbx/parallel`) on `torch.distributed`."""
