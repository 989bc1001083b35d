from repro_torch.kernels.quantize_em.ops import (  # noqa: F401
    quantize, quantize_dynamic, prepare_dynamic, quantize_prepared,
    format_row, IDENTITY_ROW,
)
