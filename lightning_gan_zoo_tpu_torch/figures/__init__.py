from .types import (AnimationFigure, AzimuthGif, AzimuthStep, ElevationGif,
                    ElevationStep, Figure, FigureContext, Interpolation,
                    Interpolation3d, SampleGrid)
from .anigan_figures import AniganTurntable, FullShapeAnalysis

__all__ = ["Figure", "AnimationFigure", "FigureContext", "SampleGrid",
           "Interpolation", "Interpolation3d", "AzimuthStep", "ElevationStep",
           "AzimuthGif", "ElevationGif", "FullShapeAnalysis",
           "AniganTurntable"]
