"""Tools of the port: `profile_paths` (device time by kernel; needs a CUDA
card) and `eval_matching` (matching quality on the real fixtures; any
device)."""
