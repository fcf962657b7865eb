"""minplus_roofline.serve: as minplus_roofline.solve, for the lane kernel
of the server's batches, each launch relaxing every lane of a batch."""

from perfkit.roofline import roofline_share

KERNELS = ("pack_records_kernel", "minplus_resident_lanes_kernel")


def read(rec):
    return roofline_share(rec, KERNELS, main="minplus_resident_lanes_kernel", lanes=rec.lanes)
