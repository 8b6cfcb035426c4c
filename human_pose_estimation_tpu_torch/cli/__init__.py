"""Command lines of the port, one counterpart for each of
``human_pose_estimation_tpu/cli/``'s: ``train``, ``train_many``,
``validate_checkpoint``, ``predict``, ``serve``, ``export_model``,
``create_synthetic``, ``create_datasets``, ``import_encoder``,
``import_checkpoint``, ``visualize_datasets`` and ``preview``, each run as
``python -m human_pose_estimation_tpu_torch.cli.<name> --flags``. Those
that run a model do so on ``cuda``; ``main(argv, device="cpu")`` runs one
on the CPU (the tests). TensorFlow and OpenCV are imported only inside
the functions that use them.
"""
