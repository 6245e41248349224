from .convert import params_from_numpy
from .model import Model, build
