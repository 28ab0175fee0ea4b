"""Multi-device layer: the device mesh (a list of torch devices), the
landmark-sharded global bundle adjustment and the multi-stream tracking
frontend. Port of ``orbslam3_tpu/parallel/``; one process drives every
device, as one JAX process drives its mesh."""
