"""The check, roofline stages and control of loops whose kept items are
frames: (pool index, the frame's `KeyPoints.as_arrays()`, descriptors)."""
from __future__ import annotations

import numpy as np

from featbench import check as C
from featbench.reference import semantics as RS
from featbench.roofline import stages as ST


def as_port(arrays: dict, desc) -> dict:
    """Host arrays and descriptors as one dict of numpy arrays."""
    out = {k: np.asarray(v) for k, v in arrays.items()}
    out["desc"] = np.asarray(desc)
    return out


def descriptor(config: dict) -> tuple[str, int]:
    """(kind, bits) of the configuration's descriptor_type."""
    kind, bits = config["detector"]["descriptor_type"].rsplit("_", 1)
    return kind, int(bits)


def frame_stages(ref_frame: dict, config: dict) -> dict:
    """The roofline's stages of detecting and describing one frame."""
    return ST.detect_describe(
        ref_frame, RS.disc_pixels(config["detector"]["nonmax_radius"]),
        len(RS.ic_offsets()[0]), *descriptor(config))


class FrameLoop:
    frames_per_step = 1

    @staticmethod
    def host(kept):
        return kept

    @staticmethod
    def pool_indices(kept) -> list:
        return [item[0] for item in kept]

    @staticmethod
    def readings(kept, ref, maps, traffic, device) -> list:
        return [C.frame_readings(as_port(arrays, desc), ref[i])
                for i, arrays, desc in kept]

    @staticmethod
    def stages(item, ref, config, traffic) -> dict:
        return frame_stages(ref[item[0]], config)

    @classmethod
    def step_frames(cls, k, n, traffic) -> list:
        per = traffic.get("batch", 1)
        return [(k * per + i) % n for i in range(per)]

    @classmethod
    def stand_in(cls, steps, n, ctl, traffic, device, dtype) -> list:
        return [(i, {k: v for k, v in ctl[i].items() if k != "desc"},
                 ctl[i]["desc"])
                for k in steps for i in cls.step_frames(k, n, traffic)]
