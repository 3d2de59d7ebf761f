"""The paper's tables on the port: ``table_v`` (the multipliers'
arithmetic error), ``table_vi_vii`` (their area, power and delay),
``table_viii`` (the evaluation CNNs' accuracy before and after retraining
through K1), ``ablation_removal`` (which partial product MUL8x8_3 drops)
and ``kernel_bench`` (the approximate matmul's execution modes side by
side, and the decode engines).  Each runs as ``python -m
repro_torch.paper.<name>``."""
