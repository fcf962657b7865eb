"""minplus_roofline.solve: % of the single-query relaxation's least time
(its rounds times the bytes of its inputs at the memory rate,
perfkit.roofline) in the device time of the kernels it launches."""

from perfkit.roofline import roofline_share

KERNELS = ("pack_records_kernel", "minplus_resident_kernel")


def read(rec):
    return roofline_share(rec, KERNELS, main="minplus_resident_kernel", lanes=1)
