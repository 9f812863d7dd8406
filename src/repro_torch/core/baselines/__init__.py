"""The paper's baselines on sample-partitioned shards: plain gradient
descent, DANE and CoCoA+ (Figure 3's comparisons with DiSCO)."""
from repro_torch.core.baselines.cocoa import CocoaConfig, cocoa_fit
from repro_torch.core.baselines.dane import DaneConfig, dane_fit
from repro_torch.core.baselines.gd import GDConfig, gd_fit

__all__ = ["DaneConfig", "dane_fit", "CocoaConfig", "cocoa_fit",
           "GDConfig", "gd_fit"]
