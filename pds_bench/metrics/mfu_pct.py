"""Useful FLOPs of the images (training examples) completed back to back,
over their wall time, over the card's dense bfloat16 peak, in percent.
The useful count is the benchmark's frozen copy
(``pds_bench/accounting.py``): the forward pass for serving; forward,
input and weight gradients, without recompute, for training.

Back to back means the measured window, except where the traffic paces
the requests (an open loop): there the window's rate is the traffic's, so
the profiled phase's iterations, run back to back, over its wall time
stand in."""

PROFILE = True


def read(record):
    if not record.peak_flops:
        return None
    if record.paced:
        profile = record.profile
        if profile is None or not profile.images:
            return None
        start, end = profile.window_us
        images, seconds = profile.images, (end - start) / 1e6
    else:
        images, seconds = record.window_images, record.window_seconds
    if seconds <= 0:
        return None
    achieved = images * record.useful_flops_per_image / seconds
    return 100.0 * achieved / record.peak_flops
