from . import (checkpoint, compile_cache, config, gridtools, guards,
               hostcompute, logbook, metrics, photometry, profiling, special,
               struct, units)
