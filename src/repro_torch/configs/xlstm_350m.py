"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304,
sLSTM + mLSTM blocks (xLSTM[7:1]).  [arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own projections (mLSTM pf=2 up/down,
sLSTM pf=4/3 post-MLP); there is no separate transformer FFN.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    vocab=50304,
    d_model=1024,
    n_layers=24,
    n_heads=4,
    kv_heads=4,
    d_ff=0,
    mixer_pattern=("mlstm", "mlstm", "mlstm", "mlstm",
                   "mlstm", "mlstm", "mlstm", "slstm"),
    mlp_pattern=("none",),
    mlstm_proj_factor=2.0,
    ssm_chunk=512,
    norm_type="layernorm",
    activation="gelu",
    gated_mlp=False,
    tie_embeddings=True,
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat="none",
    sub_quadratic=True,            # recurrent state: long_500k runs
    notes="sLSTM layers are sequential (recurrent gate dependence); their "
          "scan trip counts are fed to the roofline supplements.",
)
