"""Kernel A's tensor-core launches that took its resident kernel (phi held
in shared memory by persistent blocks: ``csrc/fused_assign_tc_resident.cuh``),
as a share of all its tensor-core launches, in the traced span: 100 x the
port's ``kernel_a.resident_launches`` counter over its
``kernel_a.tc_launches`` (counted on the host where the route is chosen,
only while a profiler records).  None where the port keeps no such
counters or no tensor-core launch was counted."""


def read(ctx):
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counts = profiling.counters()
    launches = counts.get("kernel_a.tc_launches")
    if not launches:
        return None
    return 100.0 * counts.get("kernel_a.resident_launches", 0) / launches
