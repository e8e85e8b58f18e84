from .base import ArchConfig, ShapeSpec
