"""Adjacent ML research components: port of ``pyitd_tpu/ml/`` to PyTorch.

Module, class and function names are the JAX package's; the modules are
``torch.nn.Module``s built on ``device`` (the card unless the caller asks
for the CPU) with flax's initializers, drawn from an explicit
``torch.Generator``.  ``utils.interop.load_flax_params`` carries a flax
parameter tree into them.

Serving ``BlockFastLM`` token by token (O(1) state per token)::

    model = BlockFastLM(256, device="cuda")
    states = model.init_state(batch)            # blockfast_init_state
    for k in range(prompt.shape[1]):            # the prompt
        states, _, logits = model.step(states, prompt[:, k])
    tok = logits.argmax(-1)
    for _ in range(n_new):                      # greedy generation
        states, _, logits = model.step(states, tok)
        tok = logits.argmax(-1)

``model.step`` is ``blockfast_step(model.blocks(), states, wte(tok),
n_head=...)`` followed by ``lm_head``.  Training over a mesh is
``parallel.train`` (``make_train_step``, the rules, ``shard_params``) and
``parallel.pipeline`` (``gpipe_apply``).
"""
from .activations import rainstar
from .blockfast import (MOEMLP, BlockFastBlock, BlockFastLM,
                        blockfast_init_state, blockfast_step,
                        circular_student_t)
from .checkpoint import restore_state, save_state
from .kalman import KalmanSweepMHGains
from .layers import ITDLinear, ITDMLP, ITDRNNForecaster, VanillaMLP
from .moe import (BiMLP, FastLearnedCellX3, LinearBilinear, ModCRTMoE,
                  capacity_dispatch, router_topk)
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
from .vte import (AutoencoderBlock, BlockFastGPT, ManifoldStage, dynmix,
                  frft_time, pairwise_rot_spiral, phase_tap, phase_transport,
                  spiral_mix, subspace_iteration)
from .zoo import BatchSampler, RecurrentMLP, UnigramModel, fixed_embedding

__all__ = [
    "rainstar", "wolf", "phoenix", "Wolf", "Phoenix",
    "ITDLinear", "ITDMLP", "VanillaMLP", "ITDRNNForecaster",
    "variance_scaled_softmax", "build_haar_wavelet_basis",
    "SingleHeadWaveletAttention", "UnitaryAncillaAttention", "AnchorModule",
    "GPTConfig", "ParsevalGPT", "softcap",
    "BiMLP", "LinearBilinear", "ModCRTMoE", "capacity_dispatch",
    "router_topk", "FastLearnedCellX3", "save_state", "restore_state",
    "UltraMemCfg", "UltraMemClassifier",
    "pairwise_rot_spiral", "spiral_mix", "phase_tap", "phase_transport",
    "subspace_iteration", "frft_time", "ManifoldStage", "AutoencoderBlock",
    "BlockFastGPT",
    "RectifiedKAN", "CachedMultiheadAttention", "TapeHeadBlock",
    "MLayer", "LieMLayer",
    "WedgeTransform", "convex_softmax", "AlpertQueryGenerator",
    "ExplorerEngineerStage", "dynmix",
    "add_hypersphere_phase_heads", "PhaseHeads", "Mixer",
    "KalmanSweepMHGains",
    "circular_student_t", "MOEMLP", "BlockFastBlock", "BlockFastLM",
    "blockfast_init_state", "blockfast_step",
    "RecurrentMLP", "fixed_embedding", "UnigramModel", "BatchSampler",
    "MatrixDashboard",
]
