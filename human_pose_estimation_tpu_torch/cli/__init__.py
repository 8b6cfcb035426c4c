"""Command lines of the port (counterparts of ``human_pose_estimation_tpu/
cli/train.py``, ``validate_checkpoint.py``, ``predict.py``, ``serve.py`` and
``export_model.py``), each run as
``python -m human_pose_estimation_tpu_torch.cli.<name> --flags``. They run
on ``cuda``; ``main(argv, device="cpu")`` runs one on the CPU (the tests).
"""
