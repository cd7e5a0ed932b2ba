"""Device ms a training step spends in NCCL's all-to-all kernels (the MoE
dispatch and combine over the chips, forward and backward) in the traced
steps, averaged over the chips."""


def read(rec):
    p = rec.get("profile")
    if not p or not p.get("a2a_s") or not rec.get("profile_steps"):
        return None
    return 1e3 * p["a2a_s"] / rec["profile_steps"]
