from .base import (Expression, BoundReference, UnresolvedColumn, Literal,
                   Alias, EvalCtx, ExprError, bind_expr, infer_literal_type)
from .arithmetic import (Add, Subtract, Multiply, Divide, IntegralDivide,
                         Remainder, Pmod, UnaryMinus, Abs)
from .cast import Cast
from .conditional import If, CaseWhen, Coalesce, Least, Greatest, NullIf
from .predicates import (EqualTo, EqualNullSafe, LessThan, LessThanOrEqual,
                         GreaterThan, GreaterThanOrEqual, And, Or, Not,
                         IsNull, IsNotNull, IsNaN, In)
from .aggregates import (Sum, Count, Min, Max, Average, CollectList,
                         CollectSet, ApproxPercentile)
from .complex import (GetStructField, GetArrayItem, CreateNamedStruct,
                      Size, MapKeys, MapValues)
from .hashes import Murmur3Hash, XxHash64
from .strings import RegExpReplace, RegExpExtract

__all__ = ["Expression", "BoundReference", "UnresolvedColumn", "Literal",
           "Alias", "EvalCtx", "ExprError", "bind_expr",
           "infer_literal_type", "Add", "Subtract", "Multiply", "Divide",
           "IntegralDivide", "Remainder", "Pmod", "UnaryMinus", "Abs",
           "Cast", "If", "CaseWhen", "Coalesce", "Least", "Greatest",
           "NullIf", "EqualTo", "EqualNullSafe", "LessThan",
           "LessThanOrEqual", "GreaterThan", "GreaterThanOrEqual", "And",
           "Or", "Not", "IsNull", "IsNotNull", "IsNaN", "In", "Sum",
           "Count", "Min", "Max", "Average", "CollectList", "CollectSet",
           "ApproxPercentile", "GetStructField", "GetArrayItem",
           "CreateNamedStruct", "Size", "MapKeys", "MapValues",
           "Murmur3Hash", "XxHash64", "RegExpReplace", "RegExpExtract"]
