from .multistream import (make_sharded_step, stream_mesh,  # noqa: F401
                          MultiStreamEngine)
from .rowsharded import make_rowsharded_step  # noqa: F401
from .multihost import (init_multihost, MultiHostInfo,  # noqa: F401
                        MultiHostStreamEngine)
