"""Feature gates of the scan, threaded explicitly.

The port's own copy of the JAX package's config.ScanConfig, with the gates
that mean something off the TPU. The execution switches of the JAX package
(the latency-shaped graph, the Pallas and interpret flags, the warp
variants) select between lowerings that the port does not have.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    scan_expiry: bool = True          # SCAN_EXPIRY: read the date too
    collect_card_number: bool = True  # the number-score check gates `usable`
    scan_forever: bool = False        # SCAN_FOREVER (scan.cpp:13): never
    #                                   complete, for steady-state profiling
    expiry_allow_past_dates: bool = False  # the DMZ_DEBUG/CYTHON_DMZ date
    #                                   branch (expiry_categorize.cpp:382-397)
    n_streams: int = 256              # concurrent camera streams per card

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = ScanConfig()
