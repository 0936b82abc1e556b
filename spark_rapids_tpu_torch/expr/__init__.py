from .base import (Expression, BoundReference, UnresolvedColumn, Literal,
                   Alias, EvalCtx, ExprError, bind_expr, infer_literal_type)
from .arithmetic import Multiply, Subtract
from .predicates import (EqualTo, LessThan, LessThanOrEqual, GreaterThan,
                         GreaterThanOrEqual, And)
from .aggregates import Sum, Count

__all__ = ["Expression", "BoundReference", "UnresolvedColumn", "Literal",
           "Alias", "EvalCtx", "ExprError", "bind_expr",
           "infer_literal_type", "Multiply", "Subtract", "EqualTo", "LessThan",
           "LessThanOrEqual", "GreaterThan", "GreaterThanOrEqual", "And",
           "Sum", "Count"]
