from . import corruptions
