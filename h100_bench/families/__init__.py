"""The program's side of each model family: the port's ``ModelConfig`` for a
configuration file, and the program's weights (the benchmark's own weights
through the port's ``fuse_params`` / ``quantize_params``, and the LANTERN
nearest table the port derives from the benchmark's codebook latents).  A
family is found by the configuration's ``family`` key."""
