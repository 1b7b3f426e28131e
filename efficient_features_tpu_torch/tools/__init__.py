"""Tools of the port: `profile_paths` (device time by kernel; needs a CUDA
card), `eval_matching` (matching quality on the real fixtures; any
device), `dryrun_multichip` (the mesh forms over spawned ranks) and
`oncard` (helpers of the runs on a card: the card's name, host syncs and
the tie and equal-response test images)."""
