"""``pointnet_roofline.<path>`` (%): the ``vlsat::pointnet_encode`` kernel's
share of its bound.  Its bound is the PointNet FLOPs of the valid rows and
instances of the batches whose step started in the profiled slice (each
edge's union cloud and each instance's points, ``harness/union.py``
``pointnet_flops``), counted as three TF32 products, at the card's
fp32-accurate peak (``harness/roofline.py``: 495 TFLOP/s / 3); its time is
the profiled time of the kernel over the slice."""


def read(obs, name):
    tr, peaks = obs.get("trace"), obs.get("peaks")
    batches, flops = obs.get("traced_batches"), obs.get("pointnet_flops")
    if obs["kind"] != name.split(".", 1)[1] or not tr or not peaks or not batches or not flops:
        return None
    seconds = sum(t for k, (t, _) in tr["kernels"].items() if "pointnet_kernel" in k)
    if seconds <= 0:
        return None
    per_row, per_instance = flops
    work = sum(edges * per_row + instances * per_instance for edges, instances in batches)
    return 100.0 * (work / peaks["fp32_flops"]) / seconds
