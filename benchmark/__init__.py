"""The benchmark of the PyTorch and CUDA port (``lpbox_admm_tpu_torch``):
``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  See run.py."""
