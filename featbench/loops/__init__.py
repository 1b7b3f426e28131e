"""The loops that drive the program, one file each, found by name.

A traffic file's "loop" names `featbench/loops/<loop>.py`, which defines
`Loop`, a closed loop with one step in flight:
- `Loop(feat, frames, traffic)`: the program's `EfficientFeatures`, the
  pool of host frames and the traffic's parameters;
- `frames_per_step`: frames a step completes;
- `prime(k)`: what the first step needs from a step k before it (untimed);
- `step(k, spans)`: one step, done when its results are on the host, with
  each call into the program inside `spans.port(name)`; returns the items
  the check may keep;
- and, for the check, the roofline and the control, without an instance:
  `host(kept)` (host copies of kept items, once the window is over),
  `pool_indices(kept)` (the pool frames the reference computes for them),
  `readings(kept, ref, maps, traffic, device)` (the check's numbers of
  each), `stages(item, ref, config, traffic)` (the roofline's work of one
  item), `step_frames(k, n, traffic)` (the pool frames step k hands over)
  and `stand_in(steps, n, ctl, traffic, device, dtype)` (the items the
  control gives for those steps of a pool of n, from its outputs `ctl`
  of those frames).

`base.FrameLoop` holds the last six for loops whose items are frames.
"""
