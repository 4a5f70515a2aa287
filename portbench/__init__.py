"""The benchmark of ``kubernetes_tpu_torch``, the PyTorch and CUDA port:
``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout (see ``run.py``)."""
