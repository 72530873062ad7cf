"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM) [arXiv:2405.04517]."""
from repro_torch.configs.base import ArchConfig, XLSTMSpec, register

CONFIG = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                 # xLSTM blocks carry their own projections
    vocab=50304,
    xlstm=XLSTMSpec(period=8, slstm_index=7),
    source="arXiv:2405.04517",
))
