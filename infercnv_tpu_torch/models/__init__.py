from infercnv_tpu_torch.models.hmm import (  # noqa: F401
    HMMParams,
    assign_states_to_proxy_values,
    cnv_mean_sd_trend_fit,
    get_spike_dists,
    i3_hmm_params,
    i6_hmm_params,
    predict_hmm_on_cells,
    predict_hmm_on_groups,
    viterbi_per_group,
)
from infercnv_tpu_torch.models.hspike import build_hspike  # noqa: F401
