"""``cstp_tpu_torch/graft_entry.py dryrun_multichip`` on the CPU: the data-
parallel steps in two gloo processes, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip`` variants."""

from cstp_tpu_torch.graft_entry import dryrun_multichip

from _torch_threads import torch_threads  # noqa: F401


def test_dryrun_multichip_two_gloo_ranks():
    lines = dryrun_multichip(2, timeout=120).splitlines()
    for name in ("default", "sync_bn=0", "shard_opt_state", "shard_spatial",
                 "finetune+eval", "retrieval"):
        found = [ln for ln in lines if f"[{name}]" in ln]
        assert len(found) == 1 and found[0].endswith(" ok"), (name, lines)
    spatial = [ln for ln in lines if "[shard_spatial]" in ln][0]
    assert "mesh (1, 2)" in spatial, spatial
    assert len(lines) == 6, lines
