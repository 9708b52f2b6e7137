"""Keras-1 regularizer factories (port of
``analytics_zoo_tpu.keras.regularizers``): ``W_regularizer=
regularizers.l2(5e-4)``. A regularizer is a callable ``weight -> scalar
penalty`` that ``KerasNet.regularization`` sums into the training loss
(``keras.engine.base.Regularizer``)."""

from analytics_zoo_tpu_torch.keras.engine.base import L1, L2, L1L2


def l1(l1=0.01):
    """``W_regularizer=regularizers.l1(...)``: an L1 penalty."""
    return L1(l1)


def l2(l2=0.01):
    """``W_regularizer=regularizers.l2(...)``: an L2 penalty."""
    return L2(l2)


def l1l2(l1=0.01, l2=0.01):
    """A combined L1 + L2 penalty."""
    return L1L2(l1=l1, l2=l2)


__all__ = ["L1", "L2", "L1L2", "l1", "l2", "l1l2"]
