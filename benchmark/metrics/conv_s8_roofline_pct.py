"""conv_s8_roofline_pct: the int8 3x3 conv kernel
(abcnet_tpu_torch/csrc/conv_s8.cu, `conv3x3_s8_kernel`) against its
roofline. The least time of a batch's 28 int8 sites (per site the larger
of its bytes over 3.35 TB/s and its int8 operations over 1,979 TOP/s;
benchmark/counts.py) over the summed device time a batch of the kernels
named here, in percent. Nothing to read where no such kernel ran."""

from benchmark import counts

KERNELS = ("conv3x3_s8_kernel",)


def read(obs):
    us = obs.trace.kernel_us(KERNELS)
    if not us or not obs.units:
        return None
    per_batch_s = us / 1e6 / obs.units
    return 100.0 * counts.conv_s8_bound_s(
        obs.cfg, obs.traffic["batch"]) / per_batch_s
