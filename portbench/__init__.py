"""The benchmark of ``human_pose_estimation_tpu_torch`` on NVIDIA H100
cards: ``python3 -m portbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (README.md says more)."""
