from .transform import Transform
from .layer import Layer
from . import color
