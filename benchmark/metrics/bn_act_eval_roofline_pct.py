"""bn_act_eval_roofline_pct: the eval-mode bn_act kernel
(abcnet_tpu_torch/csrc/bn_act.cu (e), `eval_kernel`) against its roofline.
The least time of a batch's 28 eval BatchNorm sites (each bf16 conv
output read once and written once, over 3.35 TB/s; benchmark/counts.py)
over the summed device time a batch of the kernels named here, in
percent. Nothing to read where no such kernel ran."""

from benchmark import counts

KERNELS = ("eval_kernel",)


def read(obs):
    us = obs.trace.kernel_us(KERNELS)
    if not us or not obs.units:
        return None
    per_batch_s = us / 1e6 / obs.units
    return 100.0 * counts.bn_act_eval_bound_s(
        obs.cfg, obs.traffic["batch"]) / per_batch_s
