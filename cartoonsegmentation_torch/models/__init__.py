from .isnet import ISNetDIS  # noqa: F401
from .kenburns import Inpaint  # noqa: F401
from .leres import LeReS  # noqa: F401
from .rtmdet import AnimeDetector  # noqa: F401
