from .astnodes import (
    Node, Const, Str, Name, Mem, Un, Bin, Asn, CallExpr, LoopExpr, Cond,
    Block, IfStmt, WhileStmt, FuncDef,
)
from .lexer import Lexer, Token, LexError
from .parser import Parser, ParseError, parse_section
from .sections import split_sections, preprocess_imports
from .directives import (
    SliderDecl, FileSlotDecl, parse_slider_decls, parse_fileslot_decls,
    parse_pin_decls, parse_options, memtop_slots, parse_desc,
)
