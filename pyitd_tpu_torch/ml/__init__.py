"""Adjacent ML research components: port of ``pyitd_tpu/ml/`` to PyTorch.

Module, class and function names are the JAX package's; the modules are
``torch.nn.Module``s built on ``device`` (the card unless the caller asks
for the CPU) with flax's initializers, drawn from an explicit
``torch.Generator``.  ``utils.interop.load_flax_params`` carries a flax
parameter tree into them.  The MoE, VTE and BlockFast families are not
ported yet.
"""
from .activations import rainstar
from .checkpoint import restore_state, save_state
from .kalman import KalmanSweepMHGains
from .layers import ITDLinear, ITDMLP, ITDRNNForecaster, VanillaMLP
from .newgpt import (AlpertQueryGenerator, ExplorerEngineerStage,
                     WedgeTransform, convex_softmax)
from .optimizers import Phoenix, Wolf, phoenix, wolf
from .parseval import (AnchorModule, GPTConfig, ParsevalGPT,
                       SingleHeadWaveletAttention, UnitaryAncillaAttention,
                       build_haar_wavelet_basis, softcap,
                       variance_scaled_softmax)
from .phase import Mixer, PhaseHeads, add_hypersphere_phase_heads
from .tape import (CachedMultiheadAttention, LieMLayer, MLayer, RectifiedKAN,
                   TapeHeadBlock)
from .ultramem import UltraMemCfg, UltraMemClassifier
from .visualizer import MatrixDashboard
from .zoo import BatchSampler, RecurrentMLP, UnigramModel, fixed_embedding

__all__ = [
    "rainstar", "wolf", "phoenix", "Wolf", "Phoenix",
    "ITDLinear", "ITDMLP", "VanillaMLP", "ITDRNNForecaster",
    "variance_scaled_softmax", "build_haar_wavelet_basis",
    "SingleHeadWaveletAttention", "UnitaryAncillaAttention", "AnchorModule",
    "GPTConfig", "ParsevalGPT", "softcap", "save_state", "restore_state",
    "UltraMemCfg", "UltraMemClassifier",
    "RectifiedKAN", "CachedMultiheadAttention", "TapeHeadBlock",
    "MLayer", "LieMLayer",
    "WedgeTransform", "convex_softmax", "AlpertQueryGenerator",
    "ExplorerEngineerStage",
    "add_hypersphere_phase_heads", "PhaseHeads", "Mixer",
    "KalmanSweepMHGains",
    "RecurrentMLP", "fixed_embedding", "UnigramModel", "BatchSampler",
    "MatrixDashboard",
]
